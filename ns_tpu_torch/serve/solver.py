"""Simulation-as-a-service: the classical solver behind the SAME request
contract as the surrogate engine.

Port of `ns_tpu/serve/solver.py`. A SolverEngine serves the periodic
spectral solver (solvers/spectral_periodic.py) through the identical
predict(frame0, n_steps) -> (n_steps+1, 3, nx, ny) surface and HTTP
protocol as serve.engine.InferenceEngine. Because the contracts match, a
client can point the same code at a surrogate endpoint or at the oracle
endpoint: on-demand ground truth for A/B evaluation, or physics serving
where model error is unacceptable. `stride` (solver steps per served
frame) aligns the solver's cadence with a surrogate trained on strided
frames.

The JAX engine compiles an init program and chunked scans (one program
per power-of-two tail length). Here the same work runs eagerly: an init
(the request's (u, v) -> vorticity or velocity spectrum and the AB2
history), then chunks of at most `chunk` frames, each `stride` steps of
the solver's `make_step`, the (u, v, p) (3D: (u, v, w, p)) recovery on the
card, and one host copy a chunk, as InferenceEngine runs its rollouts.
Nothing is compiled, so exactly the frames asked for run and
`stats()["compiled_programs"]` is 0. Entry points run on the card unless
given `device="cpu"`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.serve.engine import ServingBase


class _ChunkedSolver(ServingBase):
    """The request loop both oracles share: validate, init, chunks of
    frames with one host copy each. Subclasses set `_state_shape`, `cfg`,
    `_init(frame0) -> carry` and `_emit(carry) -> (C, ...) frame`."""

    def _setup(self, stride: int, chunk: int, device):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.stride, self.chunk = stride, chunk
        self.device = resolve_device(device)

    def predict(self, frame0: np.ndarray, n_steps: int) -> np.ndarray:
        frame0 = np.asarray(frame0, dtype=np.float32)
        shape = self._state_shape
        if frame0.shape != shape:
            raise ValueError(
                f"frame0 must be {shape}; got {frame0.shape} (solver "
                "serving is single-state)")
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        t0 = time.perf_counter()
        np_dtype = np.float64 if self.cfg.dtype == "float64" else np.float32
        out = np.empty((n_steps + 1,) + shape, np_dtype)
        host = torch.from_numpy(out)
        with torch.inference_mode():
            carry = self._init(torch.tensor(frame0, device=self.device))
            host[0].copy_(self._emit(carry))
            frames = torch.empty((min(self.chunk, n_steps),) + shape,
                                 dtype=self.cfg.real_dtype, device=self.device)
            done = 0
            while done < n_steps:
                length = min(self.chunk, n_steps - done)
                for i in range(length):
                    for _ in range(self.stride):
                        carry, _ = self._step(carry)
                    frames[i] = self._emit(carry)
                host[done + 1:done + 1 + length].copy_(frames[:length])
                done += length
        self._record(time.perf_counter() - t0, n_steps)
        return out

    def warmup(self, n_steps: int = 1) -> None:
        """Run one request (cuFFT and cuBLAS plans, the cached tables)
        before the first timed one."""
        self.predict(np.zeros(self._state_shape, np.float32), n_steps)

    def stats(self) -> dict:
        return {"model": self.model_name, "stride": self.stride,
                **self._stats_base()}


class SolverEngine(_ChunkedSolver):
    """Serve spectral-solver rollouts from physical (u, v, p) states.

    predict(frame0, n_steps) -> frames:
      frame0  (3, nx, ny) float32 — (u, v, p); vorticity is derived
              exactly and p is recomputed from it, so only the velocity
              carries information (as in the physics). An arbitrary
              input is implicitly projected onto the solenoidal,
              zero-mean, 2/3-dealiased manifold the solver evolves;
              solver- or surrogate-produced frames already live on it
              and round-trip exactly.
      frames  (n_steps + 1, 3, nx, ny) in the config's dtype; frames[0]
              echoes the (projected) input state, frames[i] is the state
              after i * stride solver steps.
    """

    model_name = "solver:spectral_periodic"
    n_models = 1

    def __init__(self, nx: int, ny: int, dt: float = 1e-3,
                 nu: float = 1e-3, stride: int = 1, chunk: int = 64,
                 dtype: str = "float32", forcing: str = "none",
                 forcing_k: int = 4, forcing_amp: float = 0.1,
                 device=None):
        from ns_tpu_torch.solvers import spectral_periodic as sp
        self._setup(stride, chunk, device)
        self.nx, self.ny = nx, ny
        self._state_shape = (3, nx, ny)
        self._sp = sp
        self.cfg = sp.SpectralPeriodicConfig(nt=1, nx=nx, ny=ny, dt=dt,
                                             nu=nu, dtype=dtype,
                                             forcing=forcing,
                                             forcing_k=forcing_k,
                                             forcing_amp=forcing_amp)
        self._step, self._ops = sp.make_step(self.cfg, self.device)
        self._carry = sp._carry_builder(self.cfg, self.device)
        self._extract = sp.make_extractor(self.cfg, self.device)
        self._init_serving()

    def _init(self, frame0: torch.Tensor):
        """(u, v, p) float32 -> the solver's carry: w = dv/dx - du/dy
        (models/vorticity.py's formula) with the forward transform in the
        request's float32, as the JAX engine takes it, and the rest in
        the config's dtype."""
        sp, ops = self._sp, self._ops
        u_hat, v_hat = torch.fft.rfft2(frame0[:2]).to(
            self.cfg.complex_dtype).unbind(0)
        w_hat = sp._ik_mul(ops["kx"], v_hat) - sp._ik_mul(ops["ky"], u_hat)
        return self._carry(sp.irfft2(w_hat, (self.nx, self.ny)))

    def _emit(self, carry) -> torch.Tensor:
        return torch.stack(self._extract(carry[0]))


class SolverEngine3D(_ChunkedSolver):
    """The 3D family (solvers/spectral3d.py) behind the same serving
    contract — on-demand 3D DNS ground truth.

    predict(frame0, n_steps) -> frames:
      frame0  (4, nx, ny, nz) float32 — (u, v, w, p); only the velocity
              carries information (p is recomputed from it). Arbitrary
              inputs are implicitly Leray-projected onto the solenoidal
              2/3-dealiased manifold; solver-produced frames round-trip
              exactly.
      frames  (n_steps + 1, 4, nx, ny, nz) in the config's dtype;
              frames[0] echoes the (projected) input, frames[i] the state
              after i * stride solver steps.

    `transform="auto"` and the precision default ('high') are the JAX
    engine's: the matmul engine on the plain route below the 'auto'
    crossover, which launches no kernel of the library.
    """

    model_name = "solver:spectral3d"
    n_models = 1

    def __init__(self, nx: int, ny: int, nz: int, dt: float = 1e-3,
                 nu: float = 6.25e-4, stride: int = 1, chunk: int = 16,
                 dtype: str = "float32", transform: str = "auto",
                 forcing: str = "none", forcing_k: int = 4,
                 forcing_amp: float = 0.1, device=None):
        from ns_tpu_torch.solvers import spectral3d as s3
        self._setup(stride, chunk, device)
        self.nx, self.ny, self.nz = nx, ny, nz
        self._state_shape = (4, nx, ny, nz)
        self.cfg = s3.Spectral3DConfig(nt=1, nx=nx, ny=ny, nz=nz, dt=dt,
                                       nu=nu, dtype=dtype,
                                       transform=transform,
                                       forcing=forcing, forcing_k=forcing_k,
                                       forcing_amp=forcing_amp)
        self._step, _ = s3.make_step(self.cfg, self.device)
        self._carry = s3._carry_builder(self.cfg, self.device)
        self._extract = s3.make_extractor(self.cfg, self.device)
        self._init_serving()

    def _init(self, frame0: torch.Tensor):
        return self._carry(frame0[:3])

    def _emit(self, carry) -> torch.Tensor:
        return torch.stack(self._extract(carry[0]))
