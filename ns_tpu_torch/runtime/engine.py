"""Deployment runtime: rollout engines built once and replayed from CUDA
graphs, and exported rollout programs.

Port of `ns_tpu/runtime/engine.py`. The JAX engines trace a rollout once
and keep the compiled executable (`RolloutEngine`, `FDRolloutEngine`,
`Rollout3DEngine`), or serialize it as StableHLO (`export_*`,
`load_*_artifact`). Here:

- An engine builds the solver's init, step and read-out once, runs them
  eagerly once on a side stream (the cuFFT plans, the cuBLAS workspace,
  the cached device tables and the kernel library are built there,
  outside any capture), and then captures the rollout as CUDA graphs on
  one memory pool of its own: the init, a graph of CHUNK steps replayed
  nt // CHUNK times, one graph of the remaining steps and the read-out.
  A call copies its input into the static input buffers, replays, and
  returns a clone of the static outputs, which the next call does not
  overwrite. The hand-written kernels launch on the current stream, so
  they land in the graphs; their Python counters (`.launches`, `.calls`)
  move while capturing, not on replay.
- A step that reads the card from the host (a gate on the host: K4's and
  K5's group routes beyond the card's shared memory, the cg and
  gauss_seidel pressure loops) cannot be captured. The engine finds that
  out in its warm-up (a step under `torch.cuda.set_sync_debug_mode`
  ("error")), runs eagerly, and says so: `captured` is False and
  `eager_reason` holds the error. Both are in `stats()` and the repr.
- On the CPU there is no graph; the engine runs the same eager loop.
- `export_*` saves the init, one step and the read-out as three
  `torch.export` programs with nt in one artifact file (a zip);
  `load_*_artifact` loads them (no module of `ns_tpu_torch.solvers` is
  imported) and loops the step nt times. A program runs on the device it
  was exported on. Every configuration that an engine runs exports: the
  hand-written kernels are operators of `torch.ops.ns_tpu`
  (`ops/kernels/library.py`), which a program holds as nodes that launch
  the kernel on the card and run the twin on the CPU, and the host-gated
  cg and gauss_seidel loops are `while_loop`s (`ops/poisson.py`), which a
  program holds as loops. The loader registers the operators before it
  reads the programs.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Callable

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device

CHUNK = 50  # steps a captured graph (nt = 5000: 100 replays, not one graph)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _copy_into(static, values) -> None:
    """static[i] <- values[i]; a value that is another static buffer (a
    step that passes a carry entry through) is cloned first, so no copy
    reads a buffer an earlier copy overwrote."""
    ptrs = {s.data_ptr() for s in static}
    values = [v.clone() if v.data_ptr() in ptrs and v is not s else v
              for s, v in zip(static, values)]
    for s, v in zip(static, values):
        if v is not s:
            s.copy_(v)


def _device_records(fn, device: torch.device) -> list:
    """(name, microseconds) of each device record (kernels, memsets,
    copies) of one call of fn, by the profiler. The window holds two calls
    and keeps the second's records: on the H100 a window's first launch of
    a hand-written kernel can be missing from its records (seen after
    many profiled windows in one process, one record a window)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(device)
        with torch.profiler.record_function("measured"):
            fn()
            torch.cuda.synchronize(device)
    start = min(e.time_range.start for e in prof.events()
                if e.name == "measured")
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.start >= start]


class _Rollout:
    """init(*inputs) -> carry, step(carry) -> carry and finish(carry) ->
    outputs (tuples of tensors) run nt steps: replayed from CUDA graphs on
    the card where the step can be captured, else eagerly."""

    def __init__(self, init: Callable, step: Callable, finish: Callable,
                 inputs: tuple, nt: int):
        if nt < 0:
            raise ValueError(f"nt must be >= 0, got {nt}")
        self._init, self._step, self._finish = init, step, finish
        self.nt, self.chunk = nt, CHUNK
        self.device = inputs[0].device
        self.captured = False
        self.eager_reason = ("the CPU has no CUDA graph"
                             if self.device.type != "cuda" else None)
        self._graphs = None
        self._flops = None
        if self.device.type == "cuda":
            self._build(inputs)

    # -- the eager loop -----------------------------------------------------

    def eager(self, *inputs) -> tuple:
        """The rollout as an eager loop (what a replay must equal)."""
        carry = self._init(*inputs)
        for _ in range(self.nt):
            carry = self._step(carry)
        return self._finish(carry)

    # -- capture --------------------------------------------------------------

    def _warm_up(self, inputs) -> str | None:
        """Run init, two steps and the read-out on a side stream; the second
        step under sync debug "error". Returns the error text if the step
        reads the card from the host (it cannot be captured), else None."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        reason = None
        with torch.cuda.stream(stream):
            carry = self._step(self._init(*inputs))
            self._finish(carry)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._step(carry)
            except RuntimeError as e:
                if "synchronizing" not in str(e):
                    raise
                reason = f"the step reads the card from the host: {e}"
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        return reason

    def _build(self, inputs) -> None:
        self.eager_reason = self._warm_up(inputs)
        if self.eager_reason is not None:
            return
        pool = torch.cuda.graph_pool_handle()
        self._in = tuple(x.clone() for x in inputs)

        def capture(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                fn()
            return g

        def init():
            # distinct buffers: an init may hand one tensor to two entries
            # (chorin_fd seeds u_prev with u)
            self._carry = tuple(t.clone() for t in self._init(*self._in))

        def advance(n):
            carry = self._carry
            for _ in range(n):
                carry = self._step(carry)
            _copy_into(self._carry, carry)

        def finish():
            self._out = tuple(self._finish(self._carry))

        full, rest = divmod(self.nt, self.chunk)
        graphs = {"init": capture(init)}
        if full:
            graphs["chunk"] = capture(lambda: advance(self.chunk))
        if rest:
            graphs["rest"] = capture(lambda: advance(rest))
        graphs["finish"] = capture(finish)
        torch.cuda.synchronize(self.device)
        self._graphs = graphs
        self.captured = True

    def replay(self, *inputs) -> tuple:
        g = self._graphs
        for s, x in zip(self._in, inputs):
            s.copy_(x)
        g["init"].replay()
        for _ in range(self.nt // self.chunk):
            g["chunk"].replay()
        if "rest" in g:
            g["rest"].replay()
        g["finish"].replay()
        return tuple(o.clone() for o in self._out)

    def __call__(self, *inputs) -> tuple:
        return self.replay(*inputs) if self.captured else self.eager(*inputs)

    # -- what it costs --------------------------------------------------------

    def replay_records(self, graph: str = "chunk") -> list:
        """The device records (kernels, memsets, copies) of one replay of
        one graph, by the profiler: (name, microseconds) each."""
        return _device_records(self._graphs[graph].replay, self.device)

    def cost_analysis(self, inputs) -> dict:
        """What the port can state of a rollout's cost: the FLOPs that
        torch.utils.flop_counter.FlopCounterMode counts over one eager step,
        times nt, and the device records of one replay of the chunk graph
        (its kernel, memset and copy nodes; None where nothing is
        captured)."""
        from torch.utils.flop_counter import FlopCounterMode

        if self._flops is None:
            carry = self._init(*inputs)
            counter = FlopCounterMode(display=False)
            with counter:
                self._step(carry)
            self._flops = counter.get_total_flops()
        nodes = None
        if self.captured:
            name = "chunk" if "chunk" in self._graphs else "rest"
            if name in self._graphs:
                steps = self.chunk if name == "chunk" else self.nt
                nodes = {"steps": steps,
                         "records": len(self.replay_records(name))}
        return {"flops": self._flops * self.nt,
                "flops_note": "FlopCounterMode counts matrix products "
                              "(mm, bmm, addmm, convolutions); FFTs, "
                              "elementwise ops and the hand-written "
                              "kernels are not counted",
                "graph_nodes_per_chunk": nodes}

    def stats(self) -> dict:
        return {"nt": self.nt, "chunk": self.chunk,
                "device": str(self.device), "captured": self.captured,
                "eager_reason": self.eager_reason,
                "graphs": sorted(self._graphs) if self._graphs else []}


class _Engine:
    """What the three engines share: the `_Rollout`, `captured`, stats,
    the repr and the cost."""

    def _start(self, init, step, finish, example: tuple, nt: int) -> None:
        self._rollout = _Rollout(init, step, finish, example, nt)
        self._example = example
        self.captured = self._rollout.captured
        self.eager_reason = self._rollout.eager_reason

    def eager(self, *inputs):
        """The same rollout as an eager loop (on the card: no graph)."""
        return self._unpack(self._rollout.eager(*self._inputs(*inputs)))

    def __call__(self, *inputs):
        return self._unpack(self._rollout(*self._inputs(*inputs)))

    def _unpack(self, out: tuple):
        return out

    @property
    def cost_analysis(self) -> dict:
        return self._rollout.cost_analysis(self._example)

    def replay_records(self, graph: str = "chunk") -> list:
        return self._rollout.replay_records(graph)

    def stats(self) -> dict:
        return {"engine": type(self).__name__, **self._rollout.stats()}

    def __repr__(self) -> str:
        s = self._rollout.stats()
        return (f"{type(self).__name__}(nt={s['nt']}, chunk={s['chunk']}, "
                f"device={s['device']}, captured={s['captured']}"
                + (f", eager_reason={s['eager_reason']!r}"
                   if s["eager_reason"] else "") + ")")


# --- 2D periodic spectral engine ---------------------------------------------


def _rollout_parts(cfg, device):
    """(init, step, finish) of the 2D periodic rollout: physical w0 ->
    carry (any engine: fft / matmul / compact / real_gemm) -> physical w
    after the steps."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    build = sp._carry_builder(cfg, device)
    step, _ = sp.make_step(cfg, device)
    inv = sp.make_inverse(cfg, device)
    return ((lambda w0: tuple(build(w0))),
            (lambda c: tuple(step(c)[0])),
            (lambda c: (inv(c[0]),)))


class RolloutEngine(_Engine):
    """The 2D periodic rollout, built once and replayed (module docstring).

    engine = RolloutEngine(cfg)          # warm-up and capture here
    w_final = engine(w0)                 # replay of the captured graphs
    """

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        example = (torch.zeros((cfg.nx, cfg.ny), dtype=cfg.real_dtype,
                               device=self.device),)
        self._start(*_rollout_parts(cfg, self.device), example, cfg.nt)

    def _inputs(self, w0):
        return (_as_tensor(w0, self.cfg.real_dtype, self.device),)

    def _unpack(self, out):
        return out[0]


# --- FD-family engines -------------------------------------------------------

_FD = ("chorin_fd", "direct_fd")


def _fd_parts(family: str, cfg, u_bc, v_bc, p_bc, dtype, device):
    """(init, step, finish) of an FD cavity rollout on flat carries:
    (u0, v0, p0) physical ICs -> final (u, v, p). Init semantics follow
    each family's NavierStokesSystem: chorin_fd applies the BCs to the ICs
    (and seeds the AB2 history); direct_fd deliberately does NOT, as its
    reference applies BCs only after the first momentum update."""
    from ns_tpu_torch.core.bc import bcs_from_reference
    from ns_tpu_torch.core.state import FlowState

    u_bc, v_bc, p_bc = (bcs_from_reference(b) for b in (u_bc, v_bc, p_bc))
    if family == "chorin_fd":
        from ns_tpu_torch.solvers import chorin_fd as m

        step = m.make_step(cfg, u_bc, v_bc, p_bc, dtype=dtype, device=device)

        def init(u0, v0, p0):
            s = m.init_state(cfg, u0, v0, p0, u_bc, v_bc, p_bc, dtype=dtype,
                             device=device)
            return s.u, s.v, s.p, s.u_prev, s.v_prev

        def fd_step(c):
            s = step(FlowState(*c))
            return s.u, s.v, s.p, s.u_prev, s.v_prev
    elif family == "direct_fd":
        from ns_tpu_torch.solvers import direct_fd as m

        step = m.make_step(cfg, u_bc, v_bc, p_bc)

        def init(u0, v0, p0):
            return tuple(a.to(dtype) for a in (u0, v0, p0))

        def fd_step(c):
            s = step(FlowState(*c))
            return s.u, s.v, s.p
    else:
        raise ValueError(f"family must be chorin_fd|direct_fd, got "
                         f"{family!r}")
    return init, fd_step, (lambda c: tuple(c[:3]))


class FDRolloutEngine(_Engine):
    """The FD cavity rollout, built once and replayed (the FD counterpart
    of RolloutEngine): engine(u0, v0, p0) -> final (u, v, p). The BC lists
    may be this package's BCs or any with the same fields."""

    def __init__(self, family: str, cfg, u_bc, v_bc, p_bc,
                 dtype=torch.float32, device=None):
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        parts = _fd_parts(family, cfg, u_bc, v_bc, p_bc, dtype, self.device)
        z = torch.zeros((cfg.nx, cfg.ny), dtype=dtype, device=self.device)
        self._start(*parts, (z, z, z), cfg.nt)

    def _inputs(self, u0, v0, p0):
        return tuple(_as_tensor(a, self.dtype, self.device)
                     for a in (u0, v0, p0))


# --- 3D spectral engine ------------------------------------------------------


def _rollout3d_parts(cfg, device):
    """(init, step, finish) of the 3D rollout: physical (3, nx, ny, nz) u0
    -> physical velocity after the steps, either engine."""
    from ns_tpu_torch.solvers import spectral3d as s3

    build = s3._carry_builder(cfg, device)
    step, _ = s3.make_step(cfg, device)
    _, inv = s3.make_transforms(s3._extract_cfg(cfg), device)
    return ((lambda u0: tuple(build(u0))),
            (lambda c: tuple(step(c)[0])),
            (lambda c: (inv(c[0]),)))


class Rollout3DEngine(_Engine):
    """The 3D spectral rollout, built once and replayed (the 3D
    counterpart of RolloutEngine): engine(u0) -> velocity after nt
    steps."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        example = (torch.zeros((3, cfg.nx, cfg.ny, cfg.nz),
                               dtype=cfg.real_dtype, device=self.device),)
        self._start(*_rollout3d_parts(cfg, self.device), example, cfg.nt)

    def _inputs(self, u0):
        return (_as_tensor(u0, self.cfg.real_dtype, self.device),)

    def _unpack(self, out):
        return out[0]


# --- export ------------------------------------------------------------------


class _Program(torch.nn.Module):
    """One part of a rollout (init, step or read-out) as a module that
    torch.export can trace: tensors in, a tuple of tensors out."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return tuple(self.fn(args))


def _write_artifact(path: str, kind: str, nt: int, parts, example: tuple,
                    n_outputs: int) -> str:
    """Export init, step and read-out on `example` and write them with nt
    into one zip file at `path`."""
    init, step, finish = parts
    # distinct tensors: an export specializes on inputs that alias (one
    # zero field for u, v and p; chorin_fd's u_prev seeded with u), and the
    # program would then read one input for the other
    example = tuple(x.clone() for x in example)
    with torch.no_grad():
        carry = tuple(t.clone() for t in init(*example))
        programs = {
            "init": torch.export.export(_Program(lambda a: init(*a)),
                                        example),
            "step": torch.export.export(_Program(step), carry),
            "finish": torch.export.export(_Program(finish), carry)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w") as z:
        for name, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{name}.pt2", buf.getvalue())
        z.writestr("meta.json", json.dumps({
            "kind": kind, "nt": nt, "outputs": n_outputs,
            "device": str(example[0].device)}))
    return path


def _load_artifact(path: str, kinds: tuple) -> Callable:
    """The rollout of an artifact of one of `kinds`: init, nt steps,
    read-out, each an exported program (no module of the solvers is
    imported; the kernels' operators are registered first)."""
    import ns_tpu_torch.ops.kernels.library  # noqa: F401

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta["kind"] not in kinds:
            raise ValueError(f"{path} holds a {meta['kind']!r} rollout, not "
                             f"one of {kinds}")
        init, step, finish = (
            torch.export.load(io.BytesIO(z.read(f"{n}.pt2"))).module()
            for n in ("init", "step", "finish"))
    nt = meta["nt"]

    def run(*inputs):
        with torch.no_grad():
            carry = init(*inputs)
            for _ in range(nt):
                carry = step(*carry)
            out = finish(*carry)
        return out[0] if meta["outputs"] == 1 else tuple(out)

    return run


def export_rollout(cfg, path: str, device=None) -> str:
    """Write the nt-step 2D periodic rollout as an artifact (module
    docstring) and return its path."""
    device = resolve_device(device)
    example = (torch.zeros((cfg.nx, cfg.ny), dtype=cfg.real_dtype,
                           device=device),)
    return _write_artifact(path, "rollout", cfg.nt,
                           _rollout_parts(cfg, device), example, 1)


def load_rollout_artifact(path: str) -> Callable:
    """Load a 2D rollout artifact: w0 -> physical w after nt steps, with
    no access to the model-building code."""
    return _load_artifact(path, ("rollout",))


def export_fd_rollout(family: str, cfg, u_bc, v_bc, p_bc, path: str,
                      dtype=torch.float32, device=None) -> str:
    """Write an FD-family nt-step rollout as an artifact (any method and
    pressure mode; the kernels and the gated loops are in the programs)."""
    if family not in _FD:
        raise ValueError(f"family must be chorin_fd|direct_fd, got "
                         f"{family!r}")
    device = resolve_device(device)
    z = torch.zeros((cfg.nx, cfg.ny), dtype=dtype, device=device)
    parts = _fd_parts(family, cfg, u_bc, v_bc, p_bc, dtype, device)
    return _write_artifact(path, f"fd:{family}", cfg.nt, parts, (z, z, z), 3)


def load_fd_rollout_artifact(path: str) -> Callable:
    """Load an FD rollout artifact: (u0, v0, p0) -> final (u, v, p)."""
    return _load_artifact(path, tuple(f"fd:{f}" for f in _FD))


def export_rollout3d(cfg, path: str, device=None) -> str:
    """Write the nt-step 3D rollout as an artifact, on either engine and
    either route (the fused route's K6 and K8 are in the programs)."""
    device = resolve_device(device)
    example = (torch.zeros((3, cfg.nx, cfg.ny, cfg.nz),
                           dtype=cfg.real_dtype, device=device),)
    return _write_artifact(path, "rollout3d", cfg.nt,
                           _rollout3d_parts(cfg, device), example, 1)


def load_rollout3d_artifact(path: str) -> Callable:
    """Load a 3D rollout artifact (no model-building code needed)."""
    return _load_artifact(path, ("rollout3d",))
