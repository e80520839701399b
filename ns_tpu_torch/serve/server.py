"""Stdlib HTTP rollout service around serve.engine.InferenceEngine.

Port of `ns_tpu/serve/server.py`: the same paths, status codes, reduce
rules and coalescing scope, on the port's engines (the surrogate
`InferenceEngine` and the solver oracles of serve/solver.py).

Zero extra dependencies (http.server + numpy's .npy wire format). The
device is a single serialized resource: requests may arrive on many
threads (ThreadingHTTPServer) but engine calls run under one lock, so
concurrent clients queue rather than interleave work on the card.

Protocol (all bodies are raw `.npy` bytes — `np.save`/`np.load` on a
buffer, allow_pickle always off):

  GET  /health           -> {"ok": true, "model": ..., "grid": [nx, ny]
                             (or [nx, ny, nz] for the 3D solver
                             endpoint), "n_models": M}
  GET  /stats            -> serve.engine.InferenceEngine.stats() JSON
  POST /rollout?steps=N[&reduce=members|mean|spread]
       body:  frame0 .npy, (3, nx, ny) or (B, 3, nx, ny) float32
              ((4, nx, ny, nz) for the 3D solver endpoint)
       reply: frames .npy per the engine contract; for ensemble
              checkpoints `reduce` collapses the member axis (default
              mean; `members` returns all, `spread` the per-cell std).

Errors return JSON {"error": ...} with a 4xx/5xx status.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ns_tpu_torch.serve.engine import InferenceEngine
from ns_tpu_torch.serve.wire import npy_bytes as _npy_bytes
from ns_tpu_torch.serve.wire import npy_parse as _npy_parse

MAX_BODY_BYTES = 1 << 30


class _Handler(BaseHTTPRequestHandler):
    # engine + lock (+ optional coalescer) injected by make_server via a
    # subclass attribute
    engine: InferenceEngine = None
    lock: threading.Lock = None
    dispatcher = None  # serve.batching.CoalescingDispatcher when enabled
    quiet: bool = True

    def log_message(self, fmt, *args):  # default stderr spam off
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/health":
            model = getattr(self.engine, "model_name", None) or \
                self.engine.cfg.model
            grid = [self.engine.nx, self.engine.ny]
            if getattr(self.engine, "nz", None):  # 3D solver endpoint
                grid.append(self.engine.nz)
            self._reply_json(200, {
                "ok": True, "model": model, "grid": grid,
                "n_models": self.engine.n_models})
        elif path == "/stats":
            self._reply_json(200, self.engine.stats())
        else:
            self._reply_json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/rollout":
            self._reply_json(404, {"error": f"unknown path {url.path}"})
            return
        q = parse_qs(url.query)
        try:
            steps = int(q.get("steps", ["1"])[0])
            reduce = q.get("reduce", ["mean"])[0]
            if reduce not in ("members", "mean", "spread"):
                raise ValueError(f"reduce must be members|mean|spread, "
                                 f"got {reduce!r}")
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= MAX_BODY_BYTES:
                raise ValueError(f"body length {length} out of range")
            frame0 = _npy_parse(self.rfile.read(length))
        except (ValueError, OSError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        try:
            # single-state requests ride the coalescer when enabled: the
            # dispatcher stacks concurrent same-shape requests into ONE
            # batched engine call and slices each reply back out —
            # ensemble replies keep their members-first contract
            # (serve/batching.py). Client-batched requests (an extra
            # leading axis) keep the serialized path.
            state_rank = 4 if getattr(self.engine, "nz", None) else 3
            if self.dispatcher is not None and frame0.ndim == state_rank:
                out = self.dispatcher.submit(frame0, steps)
            else:
                with self.lock:
                    out = self.engine.predict(frame0, steps)
            if self.engine.n_models > 1:
                if reduce != "members":
                    out = out.mean(axis=0) if reduce == "mean" else \
                        out.std(axis=0)
            elif reduce == "members":
                # single-model endpoints honor the ensemble contract:
                # 'members' gains a leading member axis of 1 ...
                out = out[None]
            elif reduce == "spread":
                # ... and the spread of one member is exactly zero — NOT
                # the raw fields (a client must never mistake velocities
                # for uncertainty)
                out = np.zeros_like(out)
        except ValueError as e:   # bad shape/steps — client error
            self._reply_json(400, {"error": str(e)})
            return
        except Exception as e:    # engine/device failure — server error
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, _npy_bytes(out), "application/octet-stream")


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8765, quiet: bool = True,
                coalesce: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call .serve_forever() or drive
    it from a thread (tests).

    coalesce > 0 turns on request coalescing for surrogate engines
    (single-model or ensemble): up to `coalesce` concurrent same-shape
    single-state requests share one batched engine call
    (serve/batching.py; ensemble replies keep their members-first
    contract per request). Client-batched requests and the single-state
    solver oracles keep the serialized lock path. The returned server's
    .dispatcher (when set) owns a daemon thread; server_close() shuts it
    down."""

    class Handler(_Handler):
        pass

    Handler.engine = engine
    Handler.lock = threading.Lock()
    Handler.quiet = quiet
    dispatcher = None
    if coalesce > 0:
        if not isinstance(engine, InferenceEngine):
            raise ValueError(
                "coalesce > 0 needs a surrogate engine: the solver "
                "oracles are single-state (serve/solver.py)")
        from ns_tpu_torch.serve.batching import CoalescingDispatcher
        # share the serialized-path lock: a coalesced batch and a
        # client-batched (lock-path) request must never call the engine
        # concurrently (the card is one serialized resource)
        dispatcher = CoalescingDispatcher(engine, max_batch=coalesce,
                                          device_lock=Handler.lock)
    Handler.dispatcher = dispatcher

    class Server(ThreadingHTTPServer):
        # stdlib default listen backlog is 5: a burst of N>5 simultaneous
        # connects gets TCP-reset before accept() ever runs (measured at
        # 16 concurrent clients). Deep backlog is the correct serving
        # posture — requests queue on the socket, not in the client.
        request_queue_size = 128

        def server_close(self):
            if dispatcher is not None:
                dispatcher.close()
            super().server_close()

    srv = Server((host, port), Handler)
    srv.dispatcher = dispatcher
    return srv


def serve(engine: InferenceEngine, host: str = "127.0.0.1",
          port: int = 8765, quiet: bool = False,
          coalesce: int = 0) -> None:
    httpd = make_server(engine, host, port, quiet=quiet, coalesce=coalesce)
    model = getattr(engine, "model_name", None) or engine.cfg.model
    nz = getattr(engine, "nz", None)
    print(f"serving {model} ({engine.nx}x{engine.ny}"
          f"{f'x{nz}' if nz else ''}"
          f"{f', {engine.n_models} members' if engine.n_models > 1 else ''})"
          f" on http://{host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
