"""Request coalescing for the serving path.

Port of `ns_tpu/serve/batching.py` (no jax in it; the code is the JAX
package's). The card is one serialized resource: under
ThreadingHTTPServer each request thread would take a lock and run its own
single-state rollout, so N concurrent clients queue N rollouts while the
card runs batch-1 work. A batch-B fno_w rollout on the H100 serves ~3x the
frames a second of batch 1 at 128^2 (PERF.md, 1882-1907 against 583-681),
so the right queueing discipline is to COALESCE compatible waiting
requests into one batched engine call.

`CoalescingDispatcher` sits between the HTTP handler threads and the
engine:

  - handler threads `submit(frame0, steps)` and block on a per-request
    event;
  - one dispatcher thread drains the queue, groups the waiting requests
    by compatibility key (frame shape, dtype, steps) — only identically-
    shaped same-horizon requests can share a call — stacks up to
    `max_batch` of them, runs ONE engine call, and distributes the
    slices. The port's engine compiles nothing, so a batch of any size
    runs as it is.

Scope: surrogate InferenceEngines, single-model or ensemble. For an
M-member ensemble the engine's batched reply is (M, B, steps+1, C, ...)
— members first, the coalesced batch axis second — and the dispatcher
hands request i its `out[:, i]` slice, so every client receives exactly
the (M, steps+1, C, ...) reply the serialized single-state path would
have produced. The internal batch axis never reaches the wire; a
CLIENT-batched request keeps the serialized lock path in serve/server.py,
as do the single-state solver oracles.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class _Pending:
    frame0: np.ndarray
    steps: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


class CoalescingDispatcher:
    """One dispatcher thread funneling concurrent predict() calls into
    batched engine calls (module docstring)."""

    def __init__(self, engine, max_batch: int = 8,
                 max_wait_ms: float = 2.0,
                 device_lock: Optional[threading.Lock] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        # engine calls are NOT thread-safe (the card is one serialized
        # resource, and the engine's stats are shared): the
        # server passes its serialized-path lock here so dispatcher
        # batches and lock-path requests never run engine.predict
        # concurrently.
        self.device_lock = device_lock or threading.Lock()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._closed = False
        # guards the closed-flag/queue-put pair: without it a submit()
        # racing close() can enqueue AFTER the loop drained the close
        # sentinel and block forever on its done event.
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._coalesced = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ns-tpu-torch-serve-batcher")
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, frame0: np.ndarray, steps: int) -> np.ndarray:
        """Blocking predict through the coalescer; raises whatever the
        engine raised for this request's batch."""
        p = _Pending(np.asarray(frame0), int(steps))
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("dispatcher is closed")
            self._q.put(p)
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        with self._submit_lock:
            self._closed = True
            self._q.put(None)  # wake the loop
        self._thread.join(timeout=5)

    def stats(self) -> dict:
        with self._stats_lock:
            return {"batches": self._batches,
                    "coalesced_requests": self._coalesced}

    # -- dispatcher side -----------------------------------------------------

    def _key(self, p: _Pending):
        return (p.frame0.shape, p.frame0.dtype.str, p.steps)

    def _loop(self) -> None:
        import time
        while True:
            head = self._q.get()
            if head is None:
                # drain-and-fail anything racing close()
                while not self._q.empty():
                    p = self._q.get_nowait()
                    if p is not None:
                        p.error = RuntimeError("dispatcher closed")
                        p.done.set()
                return
            batch = [head]
            misses: list[_Pending] = []
            key = self._key(head)
            deadline = time.monotonic() + self.max_wait
            # gather compatible requests already waiting (plus whatever
            # arrives within the coalescing window); incompatible ones go
            # back for the next round in arrival order
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0 and self._q.empty():
                    break
                try:
                    p = self._q.get(timeout=max(timeout, 0.0))
                except queue.Empty:
                    break
                if p is None:
                    self._q.put(None)  # re-deliver the close sentinel
                    break
                if self._key(p) == key:
                    batch.append(p)
                else:
                    misses.append(p)
            for p in misses:
                self._q.put(p)
            self._run(batch)

    def _run(self, batch: list) -> None:
        try:
            x = np.stack([p.frame0 for p in batch])
            with self.device_lock:
                out = self.engine.predict(x, batch[0].steps)
            # batched reply contract: (B, steps+1, C, ...) single-model,
            # (M, B, steps+1, C, ...) ensemble — members first, so each
            # request's slice matches its serialized single-state reply
            ensemble = getattr(self.engine, "n_models", 1) > 1
            for i, p in enumerate(batch):
                p.result = np.ascontiguousarray(
                    out[:, i] if ensemble else out[i])
        except BaseException as e:  # deliver to every waiter
            for p in batch:
                p.error = e
        finally:
            with self._stats_lock:
                self._batches += 1
                self._coalesced += len(batch)
            for p in batch:
                p.done.set()
