"""Stdlib client for the ns_tpu_torch rollout service (serve/server.py).

A copy of `ns_tpu/serve/client.py`, on the port's `wire`; the wire
contract is the same, so either client talks to either server.

The reference repo's only "client" is copy-pasting the eval tail of a
training script (ref neural_spectral/spectral_ode.py:208-224); the wire
protocol here is deliberately simple enough to speak by hand (README
example), but a typed client removes the last bit of boilerplate:

    from ns_tpu_torch.serve import ServeClient
    c = ServeClient("127.0.0.1", 8765)
    c.health()                       # {"ok": True, "model": ..., ...}
    frames = c.rollout(frame0, 500)  # (501, 3, nx, ny)

Zero dependencies beyond numpy + http.client; safe against malicious
servers (allow_pickle always off). Server-side errors surface as
`ServeError` carrying the HTTP status and the server's message.
"""

from __future__ import annotations

import http.client
import io
import json
from urllib.parse import quote

import numpy as np

from ns_tpu_torch.serve.wire import npy_bytes as _npy_bytes


class ServeError(RuntimeError):
    """Server returned an error reply ({"error": ...} with 4xx/5xx)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServeClient:
    """Client for one rollout endpoint (surrogate or solver oracle —
    the wire contract is identical, serve/solver.py)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 timeout: float = 600.0):
        self.host, self.port, self.timeout = host, port, timeout

    # one connection per request: the server is ThreadingHTTPServer with
    # connection-per-request semantics, and this keeps the client
    # stateless/thread-safe with no pooling to manage
    def _request(self, method: str, path: str, body: bytes = None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            raw = resp.read()
            status = resp.status
            ctype = resp.getheader("Content-Type", "")
        finally:
            conn.close()
        if status != 200:
            try:
                msg = json.loads(raw).get("error", raw.decode("latin-1"))
            except (ValueError, AttributeError):
                msg = raw.decode("latin-1", "replace")
            raise ServeError(status, msg)
        if ctype.startswith("application/json"):
            return json.loads(raw)
        return np.load(io.BytesIO(raw), allow_pickle=False)

    def health(self) -> dict:
        return self._request("GET", "/health")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def rollout(self, frame0: np.ndarray, steps: int,
                reduce: str = None) -> np.ndarray:
        """POST /rollout: evolve `frame0` ((3, nx, ny) or batched
        (B, 3, nx, ny) float32) `steps` frames forward.

        reduce: for ensemble endpoints — 'mean' (server default),
        'spread' (per-cell std), or 'members' (full member axis).
        """
        q = f"/rollout?steps={int(steps)}"
        if reduce is not None:
            q += f"&reduce={quote(str(reduce), safe='')}"
        frame0 = np.asarray(frame0, dtype=np.float32)
        return self._request("POST", q, body=_npy_bytes(frame0))
