#!/usr/bin/env python3
"""Smoke-check the ns_tpu_torch port end to end on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a
                                 # CUDA GPU, PyTorch for CUDA and nvcc

Phases (any failure exits non-zero, and no result line is printed):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile the hand-written kernels from ns_tpu_torch/csrc
               (one nvcc per source, in parallel)
  3. kernels — each kernel against its plain torch twin on the card at the
               main path's shapes (float32 and float64; K1 also at the
               largest grids one block holds; K2 with the cavity BC list
               and two others; K2's multi-block form bitwise against K2 on
               the grids one block holds, then on its resident route (one
               launch a solve) at 1024^2 and 1025^2 and on its group route
               at 4096^2; K3 one launch a call; K4 and K5 on their resident
               route, one launch a solve, and also against K5's colour-group
               kernels, K4 also at 4096^2, where it keeps one launch a gate
               group; the 3D transform
               kernels K6-K8 float32 only, each at 'default', its
               tensor-core kernel, and at 'highest', its fp32-class
               kernel (3xTF32 on the tensor cores); the
               batched routes of K1, K2 and K3, one launch for a batch of
               members, against their batched twins at B = 5, K1's batch
               with members that close their gates at different sweeps,
               and timed at B = 8, 64 and 512 beside the batch's bound), with
               its time beside the twin's (measured in turns: twin, kernel,
               kernel, twin; K6-K8 at both precisions), the FD kernels'
               profiler device time too, K6's and K7's beside
               one cuFFT call of the same function (in the turns of
               both precisions), K8's at 'highest' beside a composite of
               cuFFT calls (six irfft2, u x omega, three rfft2), and the
               bound each call's bytes and operations set (K6-K8: at the
               bf16 tensor-core peak at 'default'; at 'highest' their
               three TF32 products at the TF32 tensor-core peak, the fp32
               bound beside each, and each kernel's share of it);
               K1 is timed at 170^2 too, K3 at 51^2 too, K4 (1024^2) and K5
               (1025^2) beside the colour-group kernels
  4. main    — the port's main paths through its CLI entry point: the FD
               cavity pipeline (direct_fd and chorin_fd at the reference
               sizes; direct_fd and explicit chorin_fd at 1024^2, where
               chorin_fd's SOR takes K4, and at 1025^2, where it takes K5;
               the direct and multigrid pressure modes and the helmholtz
               predictor at 1024^2) and the 3D spectral DNS (Taylor-Green
               at 256^3, fused kernels by the 'auto' gate, K6 and K8 by
               their tensor-core kernels), then divergence_max on a 256^3
               final state (K7 by its tensor-core kernel), and the 2D
               periodic solver (decaying turbulence at 1024^2 on bench.py's
               engine, compact matmul-DFT at 'default'; taylor_green at the
               CLI's defaults, 256^2), then bench.py's rollout timed
               (steps/s, cell-updates/s, the device's idle share); each
               run's counts
               are read just before and just after it, every kernel must
               have launched, and every K2mb solve of the direct_fd 1024^2
               run, every K4 solve of the 1024^2 run and every K5 solve of
               the 1025^2 run must have taken the resident route (one
               launch a solve); K2mb and K3 must show one launch a call
  5. fidelity — float64 FD rollouts against the committed goldens; the
               dst, multigrid, helmholtz and exact modes on the card against
               the same rollouts on the CPU, and a float64 dst solve's
               residual; the 256^3 Taylor-Green run with the kernels against
               the same run without them (at 'highest', and the 'default'
               main run), the plain run at 'high' against 'highest'; a
               float64 3D shear flow against exp(-nu t); the 256^3
               Taylor-Green rollout at 'high' (the 3D CLI's default) timed
               fused (K6's 3xTF32 kernel at init, K8's 3xTF32 pair a
               step)
               beside plain (steps/s, median of 3 in turns); the 2D periodic
               engines (fft, compact, real_gemm) in float64 on the card
               against the CPU, a float32 1024^2 Taylor-Green run at
               'default' and 'high' against exp(-2 nu t), 'high' against
               'highest', bench.py's 'default' engine on 1024^2 decaying
               turbulence against the CPU (with a control that rounds the
               GEMM outputs to bf16 and must fail the bound), its
               divergence_max and energy decay, and diffable's 64^2
               initial-condition fit converging
  4/5, the Chebyshev family (no kernel: cuBLAS GEMMs and torch ops), after
               the phases above: chorin_spectral's reference preset (51^2,
               nt=200) under --guard must trip at the step the float64 CPU
               run trips, its frames frozen; the corrected mode at 1024^2
               (parity engine, dt 1e-6, nt=20) at 'highest' and 'default'
               under --guard must not trip; its step loop through
               profile_run (steps/s, device records a step, idle share,
               top kernels, set-up seconds); --progress --chunk 4 on
               chorin_fd and taylor_green must give the plain run's npz;
               then float64 51^2 rollouts against the chorin_spectral
               goldens at the JAX tests' bounds, the three corrected
               engines in float64 at 256^2 against the CPU (<= 1e-10), the
               cached step bitwise equal to the plain one at 1024^2
               float32, the 1024^2 divergence outside the pressure modes
               the solver deflates (float32 main run <= 50; a float64 run
               <= 1e-6 of its max), and cli.sanity
  4/5, the 2D surrogates (no kernel: cuBLAS GEMMs, cuFFT and torch ops),
               last: a fno_w checkpoint at 128^2, width 64, modes 43, depth
               4 (RESULTS.md "Scaling the showcase to 128^2"), drawn from
               np.random.default_rng(0) with the JAX init's distributions
               and written in the JAX Trainer's format, served by
               InferenceEngine.from_checkpoint(chunk=64) at B = 1 and B = 8
               (200-step requests on decaying-turbulence states of the
               port's solver: frames/s, p50 latency), one chunk under the
               profiler at each B (idle share, device records a step, top
               kernels), the B = 8 request with fft and with matmul forced;
               checks: every frame finite, no kernel of the library
               launched, the reply's spectral divergence <= 1e-5 of max|u|,
               card vs CPU over 8 float32 steps at B = 2 <= 1e-4 of
               max|u|, each of the 8 2D families in float64 at 32^2 card
               vs CPU <= 1e-10 of its max (both FNO engines), fft vs matmul
               with random complex weights within rtol 2e-4 and atol 1e-5
               (the JAX test's shapes and the served one), cli.evaluate
               --ckpt --physics --json card vs --device cpu (every number
               finite and <= 1e-5 relative; the divergence maxima, which
               are rounding noise, within 1e-5 of max|u|)
  4/5, training (no kernel of its own; its data step runs K1), last: the
               reference pipeline (run_solver chorin_fd --method
               semi_implicit at 51^2, K1 counted over its run; cli.train
               basis_ode K=10 on its first 100 frames, 20 iterations, the
               RESULTS.md head-to-head protocol cut; cli.evaluate --ckpt;
               every file the JAX CLI writes; s/iteration of 10 more
               iterations), then fno_w at 128^2, width 64, modes 43, depth 4
               (the surrogate phase's configuration), trained full batch on
               100 frames of the port's decaying turbulence (dt 1e-3, nu
               1e-3, k_peak n/12, 100 steps a frame) for 20 iterations in
               chunks of 10: finite falling losses, no kernel of the
               library launched, peak memory, one chunk under
               set_sync_debug_mode("error") (no host sync), one profiled
               chunk (it/s, idle share, device records an iteration), 10
               iterations and a resume of 10 bitwise equal to the 20; each
               of the 8 2D families' objective and gradient in float64 at
               32^2 card vs CPU <= 1e-10 (both FNO engines); the float32
               gradient at precision None <= 2e-5 of max|grad| from
               float64, also with TF32 turned on by the caller, and two
               controls with the caller's TF32 on that must fail the bound
               (the backward outside ops/gemm.py's rule; the rule taken out
               of forward and backward); a 'default' gradient <= 8e-5
               (relative L2) from a float64 emulation of its bf16-input
               GEMMs, with a control whose backward rounds nothing that
               must fail it; EnsembleTrainer with two fno_w members, 4
               iterations
  4/5, the 3D surrogates (no kernel of the library), last: 40 frames of
               64^3 decaying turbulence from the port's 3D solver (dt
               1e-3, nu 6.25e-4, k_peak 4, 100 steps a frame, 'auto' ->
               matmul at 'high'; timed), fno3d_a at 64^3, width 24, modes
               16, depth 4 (RESULTS.md's round-5 3D row: batch 4, 4-step
               pushforward with remat, lr 1e-3 cosine, 100 warm-up,
               horizon 1500, clip 1) trained 20 iterations in chunks of
               10 (finite losses, peak memory, one chunk under
               set_sync_debug_mode("error"), one profiled chunk: it/s,
               idle share, device records an iteration; 10 + a resume of
               10 bitwise equal to the 20), its checkpoint served by
               InferenceEngine.from_checkpoint at B = 1 and B = 4
               (100-step requests, chunk 16: frames/s, p50, a profiled
               chunk, and the share of its wall time that its
               device-to-host reply copy records take);
               checks: the reply's spectral divergence <= 1e-5 of
               max|u|, card vs CPU over 4 float32 steps at B = 1 <= 1e-4
               of max|u|, fno3d (with fno_project), fno3d_w and fno3d_a
               in float64 at 12^3 card vs CPU <= 1e-10 (forward,
               objective and gradient, both engines), fft vs matmul at
               the served shape within rtol 2e-4 and atol 1e-5,
               cli.evaluate --ckpt --physics card vs CPU as in the 2D
               phase, divergence_max of a field that is not band-limited
               (float64, 64^3) card vs CPU <= 1e-12, and no kernel of
               the library launched; its "[... s]" line says whether it
               kept its 90 s budget
  4/5, serving and the runtime, last: the surrogate phase's fno_w
               checkpoint behind serve/server.py's make_server(coalesce=8)
               on port 0: 8 concurrent ServeClients, 200-step requests of
               decaying-turbulence states, 3 bursts (requests/s, frames/s,
               p50 and p99 latency, the mean coalesced batch), each reply
               <= 1e-4 of max|u| from the serialized engine.predict reply
               and fewer batches than requests; a client-batched B = 8
               50-step request on the lock path, reduce=members and
               =spread; python -m ns_tpu_torch.cli.serve --port 0
               --warmup-steps 8 as a subprocess (its "serving ... on
               http://" line, /health, one request); the solver oracles
               over HTTP:
               SolverEngine 128^2 (fno_w's data physics, 100 steps a
               frame) and SolverEngine3D 64^3 (fno3d_a's, 10 steps a
               frame), 10 frames each, held to a plain step loop of the
               port's solver from the echoed state (<= 1e-4 of max|u|)
               and to the spectral divergence bound (<= 1e-5); the
               runtime engines, each captured as CUDA graphs (captured
               True), its replay bitwise equal to its eager loop, the
               kernels of one replayed call counted from the profiler's
               device records, eager and replayed steps/s in turns:
               bench.py's cell (RolloutEngine, 1024^2 compact 'default',
               nt 300), FDRolloutEngine chorin_fd explicit 51^2 (K1, K3)
               and 1024^2 (K4, K3), direct_fd 50^2 (K2) and 1024^2 (K2mb),
               Rollout3DEngine Taylor-Green 256^3 fused (K6, K8);
               run_solver --stream-dir at 1024^2
               (chorin_fd explicit: K4 and K3 counted; decaying turbulence
               on bench.py's engine) against the same command's npz run:
               files bitwise equal, the native writer, a lower device
               peak, streamed and npz steps/s; its "[... s]" line says
               whether it kept its 75 s budget
  4/5, export, last: the port's torch.export artifacts (export_*,
               load_*_artifact) of the main runs' configurations, the
               kernels inside them as operators of torch.ops.ns_tpu:
               chorin_fd explicit 51^2 nt 200 (K1, K3), 1024^2 nt 50 (K4,
               K3) and 1025^2 nt 10 (K5, K3), direct_fd jacobi 50^2 nt 200
               (K2) and 1024^2 nt 20 (K2mb), chorin_fd semi_implicit 51^2
               with cg nt 20 and gauss_seidel (while_loops), the
               1024^2 dst export and the 256^2 2D export, Taylor-Green
               256^3 fused at 'default' nt 8 (K6, K8) (gauss_seidel cut
               to nt 4: ~1 s a step): each loaded and run
               from its eager engine's inputs, bitwise the eager loop or
               within 1e-6 of max (the line says which), its kernels
               launched as often as the eager run launches them, steps/s
               of the artifact beside the eager and replayed loops (twice
               each, in turns), each engine captured but the gated loops',
               the fused 3D artifact's size beside the plain route's; its
               "[... s]" line says whether it kept its 60 s budget
  4/5, scale-out (ns_tpu_torch/parallel, launch.py; no kernel of its own
               but the FD ensembles' K1, K2, K3), last: ensemble_init +
               ensemble_rollout_final at B = 64 on bench.py's 1024^2
               engine and physics, 20 steps (the JAX package's scale-out
               record's workload, BASELINE.md:62): ensemble-steps/s
               (median of 5 and the runs), cell-updates/s, peak memory,
               the device's idle share, member 3 against its own rollout
               (w_hat <= 5e-4 and N_prev <= 4e-3 of their max: the batched
               bf16 GEMMs sum in another order; a control with bf16 GEMM
               outputs must exceed both), the same ensemble at 'high' with
               member 3 within 1e-5 of max|w| of its own rollout (both:
               whether bitwise); ensemble_fd_rollout (batched steps:
               one call a time step on the whole batch) of chorin_fd
               explicit 51^2 (K1, K3) and direct_fd 50^2 (K2) at B = 8,
               64 and 512 and chorin_fd semi_implicit 51^2 (K1, its ADI
               GEMMs member by member) at B = 8, nt 50,
               member-steps/s (median of 5 and the runs), the counts set
               to 0 just before each run and read just after: each kernel
               launched exactly nt times (one launch a step for the
               batch) and no other; every member bitwise its single
               rollout at B = 8 and 64, members 0, 1, 255 and 511 at 512;
               `python -m ns_tpu_torch.launch --nprocs 1 --platform cuda
               -- python -m ns_tpu_torch.cli.run_solver
               decaying_turbulence --dist` at 1024^2 (NCCL, world of 1,
               all_to_all): 'default' nt 200, its assembled npz's u and v
               within 1e-4 of max|u| of a single-device run that recovers
               them through the compact inverse, as --dist does, and
               within 1e-2 of the plain run (its fp32 irfft2 against the
               bf16 inverse; the plain frames one step apart must part by
               more), both rates; once the --dist run has read its rate,
               the launcher's self-test on the card (1 rank) and, at the
               same time, on a CPU gang of 4 (gloo) this script asks for,
               alongside the plain run and the checks;
               enable_nan_checks raising on a NaN made on the card,
               utils/profiling's timed and trace there (the trace holds
               chorin_fd.pressure); its "[... s]" line says whether it
               kept its 90 s budget
  4/5, the sharded solvers and data-parallel training (no kernel on
               these paths), last: tools/torch_sharded_solvers.py under
               `python -m ns_tpu_torch.launch --nprocs 1 --platform cuda`
               (NCCL, world of 1): the sharded chorin_fd at 1024^2 float32
               (explicit and corrected semi-implicit red-black, nit 200,
               nt 10, against the single-device plain route, whose SOR
               gates every sweep as the sharded one does, <= 1e-3 of max,
               the error against the kernel route, gated every 8 sweeps,
               beside it; dst nt 20 and helmholtz + dst nt 10, <= 1e-4) and at
               256^2 float64 (64 sweeps, <= 1e-10), chorin_spectral
               corrected 1024^2 float64 (dense engine, nt 10, <= 1e-10 of
               max, both set-ups timed) and spectral3d Taylor-Green 256^3
               (rollout nt 8, simulate nt 4, 'highest' <= 1e-5 and 'default'
               <= 2e-3 of max|u|, and whether bitwise), each against the
               single-device port on the card, its steps/s beside the
               single device's, no kernel launched by a sharded run, the
               collectives a step equal to the JAX budgets (24 + 1, 22 +
               2, 10 + 8, 6); cli.train --dist --dp 1 under the launcher
               and the plain cli.train on the train phase's fno_w
               configuration, 10 iterations: metrics.jsonl and checkpoint
               bitwise equal, 2 all-reduces an iteration and no other
               collective, both it/s; cli.train --n-models 2 --mesh auto
               --dist under the launcher: ensemble_mesh None at a world of
               1, its checkpoint bitwise the plain run's; its "[... s]"
               line says whether it kept its 90 s budget
After every phase the script checks that neither jax nor the JAX package
was imported. The line before the kernels line carries the card, the main
runs' and bench.py rollout's rates, the Chebyshev step loop, the
surrogate phase's rates, profiles and check values, the training
phase's rates, memory, losses and check values, the 3D surrogate
phase's (`surrogate3d`), the serving and runtime phase's
(`serve_runtime`), the export phase's (`export`), the scale-out
phase's (`scale_out`) and the sharded phase's (`sharded`). The line
before the last is {"kernels": [...]} with each kernel's route,
source, the TPU kernel it replaces, its launches on the main path, its
calls there and launches per call (K2mb, K4 and K5 also their resident
launches; K4 and K5 the colour-group kernels' time on the same input), its
largest error against its twin (float64 abs where the kernel has a float64
form, else float32 abs; `max_rel_err_f32` for all), its time beside the
twin's (the FD kernels also the profiler's device time a call,
`device_ms`), its bound (`bound_ms`, `bound_by`: the larger of the call's bytes
over 3.35 TB/s and its operations over the peak of their type) and the
library call's time (`library_ms`, null where no one PyTorch call
computes the function); K1, K2 and K3 their batched route (`batched`:
launches in each FD ensemble run, errors against the batched twin, times
and bounds at B = 8, 64 and 512); K6, K7 and K8 add both precisions' times
(`ms_default`, `ms_highest`), the 'highest' route's twin time, its bound at
its arithmetic (`bound_ms_highest`: the 3xTF32 kernels' three TF32
products a multiply-add at 495 TFLOP/s), the fp32 FMA bound
(`bound_ms_fp32`) and the kernel's share of its bound
(`share_of_bound_highest`), K6 and K7 the library call timed in the
'highest' turns (`library_ms_highest`), K8 there a composite of library
calls (`composite_ms_highest`: six irfft2, u x omega, three rfft2 and the
gather; not one call, so not `library_ms`), and all three their bf16
tensor-core launches on the main path; K1, K2, K2mb, K3, K4, K6 and K8 their
launches in one replayed call of each runtime engine (`launches_replayed`,
from the profiler). The last is {"ok": true, "device": {...}}.

Tolerances: float64 at a fixed sweep count <= 1e-10 abs (nvcc contracts to
FMA, so the kernel is not bitwise equal to its twin); float32 <= 1e-4
relative to the field's max; runs stopped by a converged gate may stop a
sweep apart, so they get 1e-4 abs (float64) and 1e-3 relative (float32).
K4 and K5 are also held against K5's colour-group kernels (`_color_groups`:
the same iterate sequence on an independent kernel) on the same input,
with the same bounds; K2's multi-block form against K2, bitwise. The 3D kernels are held against their twins at
'highest' (fp32 GEMMs, TF32 off; K6 and K7 run 3xTF32 there) and at
'default' (bf16 operands and intermediates, fp32 sums on both sides; 1e-3
relative).
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
GOLDEN = os.path.join(ROOT, "tests", "golden")


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str):
    if not cond:
        fail(msg)


# --- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(),
            f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
          f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} "
          "device(s)")
    return card


# --- phase 2 -----------------------------------------------------------------

def phase_build():
    from ns_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    path = _build.build_library()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, ROOT)}")


# --- phase 3 -----------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, twin, reps_k: int, reps_t: int):
    """(kernel ms, twin ms), measured in turns twin, kernel, kernel, twin."""
    t1 = time_ms(twin, reps_t)
    k1 = time_ms(kernel, reps_k)
    k2 = time_ms(kernel, reps_k)
    t2 = time_ms(twin, reps_t)
    return (k1 + k2) / 2, (t1 + t2) / 2


def device_ms(fn, reps: int) -> float:
    """One call's device time by the profiler: the summed duration of the
    CUDA records (kernels and memsets) of `reps` calls, over reps. Unlike
    CUDA events around back-to-back calls, it leaves out the host's time
    between launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def turns_ms(fns, reps: int) -> list:
    """Each fn's ms per call, measured in turns f0 .. fn, fn .. f0 and
    averaged."""
    first = [time_ms(f, reps) for f in fns]
    last = [time_ms(f, reps) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, last)]


# the card's published peaks (H100 SXM at 700 W): HBM bytes/s, fp32
# FMA-unit, bf16 and TF32 tensor-core FLOP/s
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
TF32_FLOPS = 495e12


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(bound ms, 'bytes' | 'operations'): the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Results:
    """Comparison errors, times and bounds per kernel."""

    def __init__(self):
        self.err64, self.abs32, self.rel32 = {}, {}, {}
        self.ms, self.plain_ms, self.bound, self.library_ms = {}, {}, {}, {}
        self.device_ms = {}  # the profiler's device time of a call
        # K4's and K5's resident route against the colour-group kernels on
        # one input, in turns: name -> (resident ms, groups ms)
        self.vs_groups = {}
        self.more = {}  # a kernel's times at another shape (K1 at 170^2)
        # K6-K8: each precision's kernel time, the 'highest' route's twin
        # time and bound
        self.extra = {}
        # K1-K3's batched routes: times and bounds per batch size
        self.batched = {}

    def compare(self, name, label, got, want, dtype, converged=False,
                rel_bound=None):
        got, want = list(got), list(want)
        worst_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        ok_finite = all(bool(torch.isfinite(g).all()) for g in got)
        if dtype == torch.float64:
            bound = 1e-4 if converged else 1e-10
            ok = worst_abs <= bound
            self.err64[name] = max(self.err64.get(name, 0.0), worst_abs)
            what = f"max_abs {worst_abs:.3e} (bound {bound:g})"
        else:
            bound = rel_bound or (1e-3 if converged else 1e-4)
            rel = worst_abs / scale
            ok = rel <= bound
            self.rel32[name] = max(self.rel32.get(name, 0.0), rel)
            self.abs32[name] = max(self.abs32.get(name, 0.0), worst_abs)
            what = f"max_rel {rel:.3e} (bound {bound:g})"
        print(f"  {name:26s} {label:44s} {what} "
              f"{'ok' if ok and ok_finite else 'MISMATCH'}")
        require(ok and ok_finite, f"{name} {label} disagrees with its twin")


def sor_sweeps(p, c, h, beta, tol, max_iter) -> list:
    """Each member's sweeps that `ops.poisson.sor_redblack` runs on a (B,
    nx, ny) batch (every member its own gate), counted: the work of a gated
    SOR solve depends on the data."""
    from ns_tpu_torch.ops import poisson
    masks = poisson.checkerboard(*p.shape[-2:], device=p.device)
    tol = poisson.dtype_float(tol, p.dtype)
    err = torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    sweeps = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    it = 1
    while it < max_iter:
        open_ = err > tol
        if not bool(open_.any()):
            break
        q = poisson.redblack_sweep(p, c, h, h, beta, masks)
        err = torch.where(open_, (q - p).abs().amax(dim=(-2, -1)), err)
        p = torch.where(open_[:, None, None], q, p)
        sweeps += open_.long()
        it += 1
    return sweeps.tolist()


def tiled_sweeps(p, c, h, beta, tol, max_iter) -> int:
    """Sweeps that the tiled gate (K4's and K5's: groups of 8 sweeps, err
    from +inf, it from 1, it += 8) runs on these inputs: the colour-group
    kernels launch once a group."""
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.ops.kernels.poisson_kernels import _color_groups
    n0 = kernels.sor_redblack_multiblock.launches
    _color_groups(p, c, h, h, beta, tol, max_iter, 8)
    return 8 * (kernels.sor_redblack_multiblock.launches - n0)


def phase_kernels(res: Results, dev):
    from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
    from ns_tpu_torch.ops import kernels, poisson
    from ns_tpu_torch.ops.kernels.poisson_kernels import _color_groups

    gen = torch.Generator().manual_seed(1234)

    def rand(nx, ny, dtype, scale=1.0):
        return (scale * torch.randn((nx, ny), generator=gen,
                                    dtype=torch.float64)).to(dev, dtype)

    def cavity_p_bc(dx, dy):
        return [dirichlet(0, "top"), neumann(0, "bottom", dx, dy),
                neumann(0, "left", dx, dy), neumann(0, "right", dx, dy)]

    def launched(fn, call):
        n0 = fn.launches
        out = call()
        torch.cuda.synchronize()
        require(fn.launches > n0, f"{fn.__name__} did not launch")
        return out

    dtypes = (torch.float32, torch.float64)
    print("phase 3: kernels against their plain twins")

    # K2: direct_fd pressure, 50^2, nit=50: the cavity p BCs, and two other
    # lists (every side Neumann but one, a repeated side) that the edge
    # plan folds otherwise into the sweep
    nx = 50
    h = 2.0 / (nx - 1)
    k2_lists = {
        "cavity": cavity_p_bc(h, h),
        "mixed": [neumann(0.5, "left", h, h), dirichlet(1.0, "right"),
                  neumann(-0.25, "top", h, h), dirichlet(0.0, "bottom")],
        "repeated": [dirichlet(2.0, "bottom"), neumann(-1.0, "right", h, h),
                     neumann(0.3, "bottom", h, h), dirichlet(-0.5, "left"),
                     neumann(0.7, "top", h, h)]}
    for tag, bcs in k2_lists.items():
        for dt_ in dtypes:
            p0, b = rand(nx, nx, dt_), rand(nx, nx, dt_, 10.0)
            k = lambda: kernels.jacobi_fused(p0, b, h, h, 50, bcs)
            t = lambda: poisson.jacobi(p0, b, h, h, 50,
                                       bc_fn=lambda q: apply_bcs(q, bcs))
            res.compare("jacobi_fused", f"50x50 nit=50 {tag} {dt_}",
                        [launched(kernels.jacobi_fused, k)], [t()], dt_)

    # K2, multi-block form: bitwise equal to K2 on the grids one block holds
    # (50^2 with the three lists, the largest grids: 170^2 float32, 120^2
    # float64), then direct_fd's pressure beyond one block, 1024^2 and odd
    # 1025^2, nit=50, on the resident route (one launch a solve), and
    # 4096^2 float32 on the group route (one launch a group of 8 sweeps)
    mbw = kernels.jacobi_multiblock
    for nx, dts, lists in ((50, dtypes, k2_lists), (120, dtypes, None),
                           (170, (torch.float32,), None)):
        h = 2.0 / (nx - 1)
        for tag, bcs in (lists or {"cavity": cavity_p_bc(h, h)}).items():
            for dt_ in dts:
                p0, b = rand(nx, nx, dt_), rand(nx, nx, dt_, 10.0)
                got = launched(mbw, lambda: mbw(p0, b, h, h, 50, bcs))
                same = torch.equal(got, kernels.jacobi_fused(p0, b, h, h, 50,
                                                             bcs))
                print(f"  {'jacobi_multiblock':26s} "
                      f"{f'{nx}x{nx} nit=50 {tag} {dt_}':44s} vs jacobi_fused "
                      f"{'bitwise equal' if same else 'DIFFERS'}")
                require(same, f"jacobi_multiblock {nx}x{nx} {tag} {dt_}: "
                        "not bitwise equal to jacobi_fused")
    for nx, dts in ((1024, dtypes), (1025, dtypes),
                    (4096, (torch.float32,))):
        h = 2.0 / (nx - 1)
        bcs = cavity_p_bc(h, h)
        resident = nx < 4096
        for dt_ in dts:
            p0, b = rand(nx, nx, dt_), rand(nx, nx, dt_, 10.0)
            n0, r0 = mbw.launches, mbw.launches_resident
            got = launched(mbw, lambda: mbw(p0, b, h, h, 50, bcs))
            require((mbw.launches - n0, mbw.launches_resident - r0)
                    == ((1, 1) if resident else (7, 0)),
                    f"K2mb {nx}x{nx} {dt_}: {mbw.launches - n0} launches "
                    f"({mbw.launches_resident - r0} resident)")
            t = lambda: poisson.jacobi(p0, b, h, h, 50,
                                       bc_fn=lambda q: apply_bcs(q, bcs))
            res.compare("jacobi_multiblock", f"{nx}x{nx} nit=50 {dt_}",
                        [got], [t()], dt_)

    # K1: chorin_fd pressure, 51^2, nit=200, tol 5e-6 and 0; and the largest
    # grids one block holds (170^2 float32, 120^2 float64: rhs_c in shared
    # memory, 16 and 8 cells a thread a colour)
    for nx, dts in ((51, dtypes), (170, (torch.float32,)),
                    (120, (torch.float64,))):
        h = 2.0 / (nx - 1)
        for dt_ in dts:
            for tol in (0.0, 5e-6):
                p0, c = rand(nx, nx, dt_), rand(nx, nx, dt_, h * h)
                k = lambda: kernels.sor_redblack_fused(p0, c, h, h, 1.25, tol,
                                                       200)
                t = lambda: poisson.sor_redblack(p0, c, h, h, 1.25, tol, 200)
                res.compare("sor_redblack_fused",
                            f"{nx}x{nx} nit=200 tol={tol:g} {dt_}",
                            [launched(kernels.sor_redblack_fused, k)], [t()],
                            dt_, converged=tol > 0)

    # K5: large-grid SOR at odd 1025^2 (its main-path shape) and 1024^2,
    # tol=0 and cap 201 (25 gate groups of k=8) so that kernel and twin stop
    # at the same sweep; both on the resident route (one launch a solve),
    # held against the twin and against the colour-group kernels
    # (`_color_groups`, the route beyond the card's shared memory)
    k5w = kernels.sor_redblack_multiblock
    for nx in (1025, 1024):
        h = 2.0 / (nx - 1)
        for dt_ in dtypes:
            p0, c = rand(nx, nx, dt_), rand(nx, nx, dt_, h * h)
            n0, r0 = k5w.launches, k5w.launches_resident
            got = launched(k5w, lambda: k5w(p0, c, h, h, 1.25, 0.0, 201))
            require((k5w.launches - n0, k5w.launches_resident - r0) == (1, 1),
                    f"K5 {nx}x{nx} {dt_}: {k5w.launches - n0} launches "
                    f"({k5w.launches_resident - r0} resident)")
            twin = kernels.sor_redblack_tiled(p0, c, h, h, 1.25, 0.0, 201)
            groups = _color_groups(p0, c, h, h, 1.25, 0.0, 201, 8)
            res.compare("sor_redblack_multiblock", f"{nx}x{nx} cap=201 {dt_}",
                        [got], [twin], dt_)
            res.compare("sor_redblack_multiblock",
                        f"{nx}x{nx} cap=201 vs colour groups {dt_}", [got],
                        [groups], dt_)

    # K4: packed-plane SOR, 1024^2 at nit=200 (tol=0: 25 gate groups of
    # k=8) and 1025x1024, off the routing predicate, both on the resident
    # route (one launch a solve); 4096^2 float32, beyond the card's shared
    # memory, on the group route (cap 17: two launches); against its twin
    # and K5's colour-group kernels
    k4w = kernels.sor_redblack_packed_multiblock
    for shape, cap, dts in (((1024, 1024), 200, dtypes),
                            ((1025, 1024), 8 * 3 + 1, dtypes),
                            ((4096, 4096), 8 * 2 + 1, (torch.float32,))):
        h = 2.0 / (shape[0] - 1)
        tag = "x".join(map(str, shape))
        resident = shape[0] < 4096
        for dt_ in dts:
            p0, c = rand(*shape, dt_), rand(*shape, dt_, h * h)
            n0, r0 = k4w.launches, k4w.launches_resident
            got = launched(k4w, lambda: k4w(p0, c, h, h, 1.25, 0.0, cap))
            groups = (cap - 1) // 8
            require((k4w.launches - n0, k4w.launches_resident - r0)
                    == ((1, 1) if resident else (groups, 0)),
                    f"K4 {tag} {dt_}: {k4w.launches - n0} launches "
                    f"({k4w.launches_resident - r0} resident)")
            twin = kernels.sor_redblack_packed_tiled(p0, c, h, h, 1.25, 0.0,
                                                     cap)
            groups = _color_groups(p0, c, h, h, 1.25, 0.0, cap, 8)
            res.compare("sor_redblack_packed_multiblock",
                        f"{tag} nit={cap} {dt_}", [got], [twin], dt_)
            res.compare("sor_redblack_packed_multiblock",
                        f"{tag} nit={cap} vs colour groups {dt_}", [got],
                        [groups], dt_)

    # K3: explicit predictor, 51^2 and 1024^2, quirk on/off, plus Neumann;
    # one launch a call
    cav_u = [dirichlet(0, "left"), dirichlet(1, "right"), dirichlet(0, "top"),
             dirichlet(0, "bottom")]
    cav_v = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    for nx in (51, 1024):
        h = 2.0 / (nx - 1)
        neu_u = [neumann(0.5, "left", h, h), dirichlet(1, "right"),
                 neumann(-0.25, "top", h, h), dirichlet(0, "bottom")]
        neu_v = [neumann(0, "bottom", h, h), dirichlet(0, "top"),
                 dirichlet(0, "left"), neumann(-1.0, "right", h, h)]
        for dt_ in dtypes:
            f = [rand(nx, nx, dt_) for _ in range(4)]
            for quirk, ub, vb, tag in ((True, cav_u, cav_v, "cavity"),
                                       (False, cav_u, cav_v, "cavity"),
                                       (True, neu_u, neu_v, "neumann")):
                args = (*f, 1e-3, h, h, 0.1, ub, vb, quirk)
                k = lambda: kernels.momentum_explicit_fused(*args)
                t = lambda: kernels.momentum_explicit(*args)
                res.compare("momentum_explicit_fused",
                            f"{nx}x{nx} quirk={quirk} {tag} {dt_}",
                            launched_once(kernels.momentum_explicit_fused, k),
                            t(), dt_)

    # times at the main path's shapes in float32 (the CLI's default dtype);
    # the converged-gate SOR cases are compared too, with the looser bound
    print("  times (kernel vs plain twin, ms per call, float32):")
    f32 = torch.float32
    h = 2.0 / 49
    p0, b = rand(50, 50, f32), rand(50, 50, f32, 10.0)
    bcs = cavity_p_bc(h, h)
    # each entry: name, label, reps, kernel, twin, (bytes, FLOP) of the call
    # (inputs read once, outputs written once; Jacobi 8 and SOR 10 FLOP per
    # interior point and sweep, the explicit predictor ~80 per point for
    # both fields)
    timed = [("jacobi_fused", "50x50 nit=50", 200, 10,
              lambda: kernels.jacobi_fused(p0, b, h, h, 50, bcs),
              lambda: poisson.jacobi(p0, b, h, h, 50,
                                     bc_fn=lambda q: apply_bcs(q, bcs)),
              (3 * 50 * 50 * 4, 8 * 48 * 48 * 50))]
    hj = 2.0 / 1023
    pj, bj = rand(1024, 1024, f32), rand(1024, 1024, f32, 10.0)
    bcj = cavity_p_bc(hj, hj)
    n2 = 1024 * 1024
    timed.append(("jacobi_multiblock", "1024x1024 nit=50", 20, 5,
                  lambda: kernels.jacobi_multiblock(pj, bj, hj, hj, 50, bcj),
                  lambda: poisson.jacobi(pj, bj, hj, hj, 50,
                                         bc_fn=lambda q: apply_bcs(q, bcj)),
                  (3 * n2 * 4, 8 * 1022 * 1022 * 50)))
    # K1 at 170^2 first: the last entry of a name is its main-path entry
    hb = 2.0 / 169
    qb, cb = rand(170, 170, f32), rand(170, 170, f32, hb * hb)
    sweeps_b = sor_sweeps(qb[None], cb[None], hb, 1.25, 5e-6, 200)[0]
    timed.append(("sor_redblack_fused", "170x170 nit=200 tol=5e-06", 10, 2,
                  lambda: kernels.sor_redblack_fused(qb, cb, hb, hb, 1.25,
                                                     5e-6, 200),
                  lambda: poisson.sor_redblack(qb, cb, hb, hb, 1.25, 5e-6,
                                               200),
                  (3 * 170 * 170 * 4, 10 * 168 * 168 * sweeps_b)))
    h1 = 2.0 / 50
    q1, c1 = rand(51, 51, f32), rand(51, 51, f32, h1 * h1)
    sweeps1 = sor_sweeps(q1[None], c1[None], h1, 1.25, 5e-6, 200)[0]
    timed.append(("sor_redblack_fused", "51x51 nit=200 tol=5e-06", 20, 2,
                  lambda: kernels.sor_redblack_fused(q1, c1, h1, h1, 1.25,
                                                     5e-6, 200),
                  lambda: poisson.sor_redblack(q1, c1, h1, h1, 1.25, 5e-6,
                                               200),
                  (3 * 51 * 51 * 4, 10 * 49 * 49 * sweeps1)))
    # K4 at 1024^2 and K5 at 1025^2, their main-path shapes; the gated
    # solves run groups of 8 sweeps
    hk = 2.0 / 1023
    qk, ck = rand(1024, 1024, f32), rand(1024, 1024, f32, hk * hk)
    sweeps_k = tiled_sweeps(qk, ck, hk, 1.25, 5e-6, 200)
    timed.append(("sor_redblack_packed_multiblock",
                  "1024x1024 nit=200 tol=5e-06", 3, 2,
                  lambda: kernels.sor_redblack_packed_multiblock(
                      qk, ck, hk, hk, 1.25, 5e-6, 200),
                  lambda: kernels.sor_redblack_packed_tiled(
                      qk, ck, hk, hk, 1.25, 5e-6, 200),
                  (3 * n2 * 4, 10 * 1022 * 1022 * sweeps_k)))
    h5 = 2.0 / 1024
    q5, c5 = rand(1025, 1025, f32), rand(1025, 1025, f32, h5 * h5)
    sweeps_5 = tiled_sweeps(q5, c5, h5, 1.25, 5e-6, 200)
    timed.append(("sor_redblack_multiblock", "1025x1025 nit=200 tol=5e-06",
                  3, 2,
                  lambda: kernels.sor_redblack_multiblock(q5, c5, h5, h5,
                                                          1.25, 5e-6, 200),
                  lambda: kernels.sor_redblack_tiled(q5, c5, h5, h5, 1.25,
                                                     5e-6, 200),
                  (3 * 1025 * 1025 * 4, 10 * 1023 * 1023 * sweeps_5)))
    for nx in (51, 1024):
        hm = 2.0 / (nx - 1)
        fm = [rand(nx, nx, f32) for _ in range(4)]
        margs = (*fm, 1e-5, hm, hm, 0.01, cav_u, cav_v, True)
        timed.append(("momentum_explicit_fused", f"{nx}x{nx}", 100, 20,
                      lambda a=margs: kernels.momentum_explicit_fused(*a),
                      lambda a=margs: kernels.momentum_explicit(*a),
                      (6 * nx * nx * 4, 80 * (nx - 2) ** 2)))
    print(f"  (sweeps run: 170x170 {sweeps_b}, 51x51 {sweeps1}, 1024x1024 "
          f"{sweeps_k}, 1025x1025 {sweeps_5})")
    shown = {}  # the label each kernel's res.ms holds
    for name, label, reps_k, reps_t, k, t, (nbytes, flops) in timed:
        if "sor" in name:
            res.compare(name, f"{label} float32", [k()], [t()], f32,
                        converged=True)
        ms, plain = paired_ms(k, t, reps_k, reps_t)
        # the last shape of each kernel is its main-path entry in the report;
        # an earlier one (K1 at 170^2, K3 at 51^2) is kept beside it
        if name in res.ms:
            tag = shown[name].split()[0].split("x")[0]
            res.more.setdefault(name, {}).update({
                f"ms_{tag}": res.ms[name], f"plain_ms_{tag}":
                res.plain_ms[name], f"bound_ms_{tag}": res.bound[name][0],
                f"device_ms_{tag}": res.device_ms[name]})
        res.ms[name], res.plain_ms[name] = ms, plain
        res.device_ms[name] = device_ms(k, min(reps_k, 20))
        res.bound[name] = bound(nbytes, flops, FP32_FLOPS)
        shown[name] = label
        print(f"  {name:26s} {label:30s} kernel {ms:.4f} ms (device "
              f"{res.device_ms[name]:.4f})  twin {plain:.4f} ms  "
              f"({plain / ms:.2f}x); bound {res.bound[name][0]:.5f} ms "
              f"({res.bound[name][1]})")
    # the resident route of K4 (1024^2) and K5 (1025^2) against the
    # colour-group kernels on the same input, in turns groups, resident,
    # resident, groups
    for name, wrapper, q, c, hq in (
            ("sor_redblack_packed_multiblock",
             kernels.sor_redblack_packed_multiblock, qk, ck, hk),
            ("sor_redblack_multiblock", kernels.sor_redblack_multiblock, q5,
             c5, h5)):
        n = q.shape[0]
        res_fn = lambda: wrapper(q, c, hq, hq, 1.25, 5e-6, 200)
        grp_fn = lambda: _color_groups(q, c, hq, hq, 1.25, 5e-6, 200, 8)
        res.compare(name, f"{n}x{n} nit=200 tol=5e-06 vs colour groups "
                    "float32", [res_fn()], [grp_fn()], f32, converged=True)
        ms_r, ms_g = paired_ms(res_fn, grp_fn, 5, 5)
        res.vs_groups[name] = (ms_r, ms_g)
        print(f"  {name:26s} {f'{n}x{n} nit=200 tol=5e-06':30s} resident "
              f"{ms_r:.4f} ms  colour groups {ms_g:.4f} ms "
              f"({ms_g / ms_r:.2f}x)")
    phase_kernels_batched(res, dev)
    phase_kernels_3d(res, dev)


# the batch sizes the batched K1, K2 and K3 are timed at: the FD
# ensemble's (SCALE["fd_B"]); 512 members run in waves (one 1024-thread
# block a member on 132 SMs)
BATCHED = {"sor_redblack_fused": "K1: one launch a batch, blockIdx.x a "
                                 "member, each member's own gate",
           "jacobi_fused": "K2: one launch a batch, blockIdx.x a member",
           "momentum_explicit_fused": "K3: one launch a batch, blockIdx.z a "
                                      "member"}


def phase_kernels_batched(res: Results, dev):
    """The batched routes of K1, K2 and K3 (the FD ensemble's: one launch
    for a (B, nx, ny) batch) against their batched twins at B = 5 (odd
    members of a 51^2 float32 batch sit 4 bytes off a 16-byte boundary;
    K1's batch holds a member at rest, whose gate closes after one sweep,
    a member started at its own solution and random ones), both dtypes;
    then timed at the ensemble's batch sizes in float32 beside a bound of
    the batch's bytes or operations (B times a member's; K1's operations
    count each member's own sweeps)."""
    from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
    from ns_tpu_torch.ops import kernels, poisson

    gen = torch.Generator().manual_seed(4321)

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    dtype=torch.float64)).to(dev, dtype)

    def tag(name):
        return f"{name}[batched]"

    print("  batched routes (K1, K2, K3 with a member axis) against their "
          "batched twins:")
    cav_u = [dirichlet(0, "left"), dirichlet(1, "right"), dirichlet(0, "top"),
             dirichlet(0, "bottom")]
    cav_v = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    for dt_ in (torch.float32, torch.float64):
        h = 2.0 / 50
        p, c = rand((5, 51, 51), dt_), rand((5, 51, 51), dt_, h * h)
        p[1], c[1] = 0.0, 0.0
        p[2] = poisson.sor_redblack(p[2], c[2], h, h, 1.25, 5e-6, 200)
        k1 = kernels.sor_redblack_fused
        for tol in (0.0, 5e-6):
            n0 = k1.launches
            got = k1(p, c, h, h, 1.25, tol, 200)
            torch.cuda.synchronize()
            require(k1.launches == n0 + 1, "batched K1: not one launch")
            sw = sor_sweeps(p, c, h, 1.25, tol, 200)
            res.compare(tag("sor_redblack_fused"),
                        f"5x51x51 nit=200 tol={tol:g} {dt_} sweeps {sw}",
                        [got], [poisson.sor_redblack(p, c, h, h, 1.25, tol,
                                                     200)],
                        dt_, converged=tol > 0)
        h = 2.0 / 49
        p, b = rand((5, 50, 50), dt_), rand((5, 50, 50), dt_, 10.0)
        bcs = [dirichlet(0, "top"), neumann(0, "bottom", h, h),
               neumann(0, "left", h, h), neumann(0, "right", h, h)]
        n0 = kernels.jacobi_fused.launches
        got = kernels.jacobi_fused(p, b, h, h, 50, bcs)
        torch.cuda.synchronize()
        require(kernels.jacobi_fused.launches == n0 + 1,
                "batched K2: not one launch")
        res.compare(tag("jacobi_fused"), f"5x50x50 nit=50 cavity {dt_}",
                    [got], [poisson.jacobi(p, b, h, h, 50, bc_fn=lambda q:
                                           apply_bcs(q, bcs))], dt_)
        for shape in ((5, 51, 51), (3, 1024, 1024)):
            h = 2.0 / (shape[1] - 1)
            f = [rand(shape, dt_) for _ in range(4)]
            args = (*f, 1e-3, h, h, 0.1, cav_u, cav_v, True)
            n0 = kernels.momentum_explicit_fused.launches
            got = kernels.momentum_explicit_fused(*args)
            torch.cuda.synchronize()
            require(kernels.momentum_explicit_fused.launches == n0 + 1,
                    "batched K3: not one launch")
            res.compare(tag("momentum_explicit_fused"),
                        f"{'x'.join(map(str, shape))} {dt_}", got,
                        kernels.momentum_explicit(*args), dt_)

    print("  batched times (ms per call, float32; bound of the batch):")
    f32 = torch.float32
    for B in SCALE["fd_B"]:
        h1 = 2.0 / 50
        q, c = rand((B, 51, 51), f32), rand((B, 51, 51), f32, h1 * h1)
        sweeps = sum(sor_sweeps(q, c, h1, 1.25, 5e-6, 200))
        h2 = 2.0 / 49
        p, b = rand((B, 50, 50), f32), rand((B, 50, 50), f32, 10.0)
        bcs = [dirichlet(0, "top"), neumann(0, "bottom", h2, h2),
               neumann(0, "left", h2, h2), neumann(0, "right", h2, h2)]
        f = [rand((B, 51, 51), f32) for _ in range(4)]
        cases = [
            ("sor_redblack_fused", lambda: kernels.sor_redblack_fused(
                q, c, h1, h1, 1.25, 5e-6, 200),
             (3 * B * 51 * 51 * 4, 10 * 49 * 49 * sweeps)),
            ("jacobi_fused", lambda: kernels.jacobi_fused(
                p, b, h2, h2, 50, bcs),
             (3 * B * 50 * 50 * 4, 8 * 48 * 48 * 50 * B)),
            ("momentum_explicit_fused",
             lambda: kernels.momentum_explicit_fused(
                 *f, 1e-5, h1, h1, 0.01, cav_u, cav_v, True),
             (6 * B * 51 * 51 * 4, 80 * 49 * 49 * B))]
        for name, call, (nbytes, flops) in cases:
            reps = max(5, 2000 // B)
            ms = (time_ms(call, reps) + time_ms(call, reps)) / 2
            dev_ms = device_ms(call, min(reps, 20))
            bound_ms, bound_by = bound(nbytes, flops, FP32_FLOPS)
            row = res.batched.setdefault(name, {})
            row.update({f"ms_B{B}": ms, f"device_ms_B{B}": dev_ms,
                        f"bound_ms_B{B}": bound_ms,
                        f"bound_by_B{B}": bound_by})
            print(f"  {name:26s} B={B:<4d} kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f}; {ms / B * 1e3:.2f} us a member); bound "
                  f"{bound_ms:.5f} ms ({bound_by})"
                  + (f"; {sweeps} sweeps in all" if "sor" in name else ""))


def phase_kernels_3d(res: Results, dev):
    """K6, K7, K8 against their twins on the main path's shapes at 256^3
    (K6 on the 3-component velocity of carry init, K7 on divergence_max's
    one field, K8 on the step's six fields) and at a non-cubic,
    non-power-of-two grid, each at 'default' (its tensor-core kernel,
    against the twin at 'default', 1e-3 of max|out|: the fp32 sums run in
    another order, which can flip a rounding of an intermediate to bf16 by
    one ulp) and at 'highest' (its 3xTF32 kernel, one `launches_tf32` a
    call, 1e-4). Then each is timed beside its twin at both precisions, in
    turns, and K6 and K7 in both turns beside one PyTorch call of the same
    function (cuFFT): rfft2 over (y, z) and the gather of the kept rows for
    K6, irfft2 of the zero-filled spectrum for K7; K8 in the 'highest'
    turns beside a composite of those calls (no one call computes it): six
    irfft2 of the zero-filled spectra of real fields, u x omega, three
    rfft2 and the gather, held against the kernel first. The main path's
    precision is 'default': `ms`, `plain_ms`, `library_ms` and the bound
    are its; `ms_highest`, `plain_ms_highest`, `library_ms_highest` (the
    library call in the 'highest' turns), `composite_ms_highest` (K8) and
    `bound_ms_highest` the other route's, its bound at the route's
    arithmetic (three TF32 products a multiply-add at the TF32 tensor-core
    peak) with the fp32 FMA bound beside it (`bound_ms_fp32`) and the
    kernel's share of its bound (`share_of_bound_highest`)."""
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.ops.kernels import transform3d_kernels as t3k
    from ns_tpu_torch.solvers import spectral3d as s3

    gen = torch.Generator().manual_seed(99)
    f32 = torch.float32
    precs = ("default", "highest")

    def crand(shape):
        z = torch.randn((*shape, 2), generator=gen, dtype=torch.float64)
        return torch.view_as_complex(z).to(dev, torch.complex64)

    print("phase 3: 3D transform kernels against their twins (float32)")
    for shape in ((N3D,) * 3, (40, 36, 30)):
        nx, ny, nz = shape
        cfg = s3.Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="matmul")
        _, rows_y, kzc = s3._compact_meta(cfg)
        ry = len(rows_y)
        M = s3._dft_tables(cfg, dev)
        w = torch.randn((3, *shape), generator=gen).to(dev, f32)
        ry_t = torch.as_tensor(rows_y, device=dev)
        # K7's input: the kept (y, z) spectrum of a real field, which is
        # Hermitian in its k_z = 0 plane as irfft2 (cuFFT's C2R) assumes
        a1 = torch.fft.rfft2(torch.randn((1, *shape), generator=gen).to(dev),
                             dim=(-2, -1))[..., ry_t, :kzc].contiguous()
        a6 = crand((6, nx, ry, kzc))
        tag = "x".join(map(str, shape))
        inv = (a1, M["Fyi_t"], M["Bz"], nz)
        lam = (a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], nz)
        cases = {  # wrapper: (label, kernel(p), twin(p))
            "fused_zy_forward": (
                "B=3", lambda p: kernels.fused_zy_forward(
                    w, M["Fz_t"], M["Fy_t"], p),
                lambda p: kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], p)),
            "fused_yz_inverse": (
                "B=1", lambda p: kernels.fused_yz_inverse(*inv, p),
                lambda p: kernels.yz_inverse(*inv, p)),
            "fused_lamb": (
                "six fields", lambda p: kernels.fused_lamb(*lam, p),
                lambda p: kernels.lamb(*lam, p)),
        }
        for name, (label, ker, twin) in cases.items():
            fn = getattr(kernels, name)
            for p in precs:
                n0, t0 = fn.launches_bf16, fn.launches_tf32
                res.compare(name, f"{tag} {label} vs twin '{p}'",
                            [launched_once(fn, lambda: ker(p))], [twin(p)],
                            f32, rel_bound=1e-3 if p == "default" else None)
                require(fn.launches_bf16 == n0 + (p == "default"),
                        f"{name} '{p}': the tensor-core kernel ran "
                        f"{fn.launches_bf16 - n0} times")
                require(fn.launches_tf32 == t0 + (p != "default"),
                        f"{name} '{p}': the 3xTF32 kernel ran "
                        f"{fn.launches_tf32 - t0} times")
        if shape[0] != N3D:
            continue
        # one PyTorch call of each function, held against the kernel
        lib6 = lambda: torch.fft.rfft2(w, dim=(-2, -1))[..., ry_t, :kzc]
        full = torch.zeros((1, nx, ny, nz // 2 + 1), dtype=torch.complex64,
                           device=dev)
        full[..., ry_t, :kzc] = a1
        lib7 = lambda: torch.fft.irfft2(full, s=(ny, nz), dim=(-2, -1))
        library = {"fused_zy_forward": (lib6, "rfft2+gather"),
                   "fused_yz_inverse": (lib7, "irfft2")}
        # K8's composite, on the kept spectra of six real fields (irfft2
        # reads their k_z = 0 planes as Hermitian)
        a6h = torch.fft.rfft2(torch.randn((6, *shape), generator=gen).to(dev),
                              dim=(-2, -1))[..., ry_t, :kzc].contiguous()
        full6 = torch.zeros((6, nx, ny, nz // 2 + 1), dtype=torch.complex64,
                            device=dev)
        full6[..., ry_t, :kzc] = a6h
        comp8 = lambda: torch.fft.rfft2(t3k.cross(torch.fft.irfft2(
            full6, s=(ny, nz), dim=(-2, -1))), dim=(-2, -1))[..., ry_t, :kzc]
        checks = [(name, lib, cases[name][1], "library call")
                  for name, (lib, _) in library.items()]
        checks.append(("fused_lamb", comp8, lambda p: kernels.fused_lamb(
            a6h, *lam[1:], p), "cuFFT composite"))
        for name, lib, ker, what in checks:
            want = ker("highest")
            rel = float((lib() - want).abs().max() / want.abs().max())
            print(f"  {name:26s} {tag} {what} vs kernel 'highest': "
                  f"max_rel {rel:.3e} (bound 1e-4)")
            require(rel <= 1e-4, f"{name}: the {what} computes another "
                    "function")
        # times at the main path's grid, in turns; bounds from the shapes
        # at each precision's peak (52.7 MFLOP of matmul-DFT per (b, x)
        # slab and stage pair at 256^3; K8 runs K7's pair on six fields and
        # K6's on three)
        cplx = 8
        slab = (4 * ny * nz * kzc + 8 * ry * ny * kzc)
        spec = nx * ry * kzc * cplx
        work = {"fused_zy_forward": (3 * nx * ny * nz * 4 + 3 * spec,
                                     3 * nx * slab, 10),
                "fused_yz_inverse": (spec + nx * ny * nz * 4, nx * slab, 10),
                "fused_lamb": (9 * spec, 9 * nx * slab, 5)}
        for name, (label, ker, twin) in cases.items():
            nbytes, flops, reps = work[name]
            fns = [lambda: twin("default"), lambda: ker("default")]
            fns_h = [lambda: twin("highest"), lambda: ker("highest")]
            if name in library:
                fns.append(library[name][0])
                fns_h.append(library[name][0])
            elif name == "fused_lamb":
                fns_h.append(comp8)
            ms = turns_ms(fns, reps)
            ms_h = turns_ms(fns_h, reps)
            ms_th, ms_kh = ms_h[:2]
            res.ms[name], res.plain_ms[name] = ms[1], ms[0]
            res.bound[name] = bound(nbytes, flops, BF16_FLOPS)
            b_fp32 = bound(nbytes, flops, FP32_FLOPS)
            b_high = bound(nbytes, 3 * flops, TF32_FLOPS)
            res.extra[name] = {
                "ms_default": ms[1], "ms_highest": ms_kh,
                "plain_ms_highest": ms_th, "bound_ms_highest": b_high[0],
                "bound_ms_fp32": b_fp32[0],
                "share_of_bound_highest": b_high[0] / ms_kh}
            lib = lib_h = ""
            if name in library:
                res.library_ms[name] = ms[2]
                res.extra[name]["library_ms_highest"] = ms_h[2]
                lib = f"  {library[name][1]} {ms[2]:.4f} ms"
                lib_h = f"  {library[name][1]} {ms_h[2]:.4f} ms"
            elif name == "fused_lamb":
                res.extra[name]["composite_ms_highest"] = ms_h[2]
                lib_h = f"  cuFFT composite {ms_h[2]:.4f} ms"
            print(f"  {name:26s} {tag} {label}: 'default' kernel "
                  f"{ms[1]:.4f} ms  twin {ms[0]:.4f} ms "
                  f"({ms[0] / ms[1]:.2f}x){lib}; bound "
                  f"{res.bound[name][0]:.4f} ms ({res.bound[name][1]}); "
                  f"'highest' (3xTF32) kernel {ms_kh:.4f} ms  twin "
                  f"{ms_th:.4f} ms ({ms_th / ms_kh:.2f}x){lib_h}; bound "
                  f"{b_high[0]:.4f} ms ({b_high[1]}; "
                  f"{b_high[0] / ms_kh:.1%} of it), fp32 bound "
                  f"{b_fp32[0]:.4f} ms")


def launched_once(fn, call):
    n0 = fn.launches
    out = call()
    torch.cuda.synchronize()
    require(fn.launches == n0 + 1, f"{fn.__name__} did not launch once")
    return out


# --- phase 4 -----------------------------------------------------------------

N3D = 256  # the 3D main path's grid, N3D^3
N2D = 1024  # bench.py's grid, N2D^2
BENCH_STEPS = 300  # steps of the timed bench.py rollout
BENCH_2D_CLI = ["decaying_turbulence", "--nx", str(N2D), "--nt", "20",
                "--dt", "5e-4", "--nu", "1e-4", "--transform", "matmul",
                "--compact", "--precision", "default"]
PERIODIC_2D = ("taylor_green", "decaying_turbulence")
TG3D = ["taylor_green_3d", "--nx", str(N3D), "--nt", "8", "--transform",
        "matmul"]
MAIN_RUNS = [
    ("direct_fd", ["direct_fd"]),
    ("chorin_fd semi_implicit", ["chorin_fd"]),
    ("chorin_fd explicit", ["chorin_fd", "--method", "explicit"]),
    ("chorin_fd explicit 1024^2", ["chorin_fd", "--method", "explicit",
                                   "--nx", "1024", "--nt", "50", "--dt",
                                   "1e-5", "--nu", "0.01"]),
    ("chorin_fd explicit 1025^2", ["chorin_fd", "--method", "explicit",
                                   "--nx", "1025", "--nt", "10", "--dt",
                                   "1e-5", "--nu", "0.01"]),
    ("direct_fd 1024^2", ["direct_fd", "--nx", "1024", "--nt", "20", "--dt",
                          "1e-5", "--nu", "0.01"]),
    ("chorin_fd dst 1024^2", ["chorin_fd", "--pressure-mode", "dst", "--nx",
                              "1024", "--nt", "20", "--dt", "1e-5", "--nu",
                              "0.01"]),
    ("chorin_fd helmholtz multigrid 1024^2", [
        "chorin_fd", "--method", "helmholtz", "--pressure-mode", "multigrid",
        "--nx", "1024", "--nt", "10", "--dt", "1e-5", "--nu", "0.01"]),
    ("direct_fd exact 1024^2", ["direct_fd", "--pressure-mode", "exact",
                                "--nx", "1024", "--nt", "20", "--dt", "1e-5",
                                "--nu", "0.01"]),
    ("taylor_green_3d 256^3", TG3D + ["--precision", "default",
                                      "--pallas-transform", "auto"]),
    # the 2D periodic family: bench.py's engine and physics at 1024^2
    # (compact matmul-DFT, 'default'), and taylor_green at the CLI's
    # defaults (256^2, transform auto, 'high', nt 200)
    ("decaying_turbulence 1024^2 compact default", BENCH_2D_CLI),
    ("taylor_green 256^2", ["taylor_green"]),
]
# the wrappers with a resident route (one cooperative launch a solve)
RESIDENT = {"jacobi_multiblock", "sor_redblack_packed_multiblock",
            "sor_redblack_multiblock"}
# the SOR solves timed beside K5's colour-group kernels on one input
COLOR_GROUPS = {"sor_redblack_packed_multiblock", "sor_redblack_multiblock"}
# one CUDA launch a call on every main-path run (K2mb: its resident route)
ONE_LAUNCH = {"jacobi_multiblock", "momentum_explicit_fused"}
MAIN_KERNELS = {  # kernels each main-path run must launch
    "direct_fd": {"jacobi_fused"},
    "chorin_fd semi_implicit": {"sor_redblack_fused"},
    "chorin_fd explicit": {"sor_redblack_fused", "momentum_explicit_fused"},
    "chorin_fd explicit 1024^2": {"sor_redblack_packed_multiblock",
                                  "momentum_explicit_fused"},
    "chorin_fd explicit 1025^2": {"sor_redblack_multiblock",
                                  "momentum_explicit_fused"},
    "direct_fd 1024^2": {"jacobi_multiblock"},
    # the direct and multigrid modes run plain torch and cuBLAS GEMMs (no
    # Pallas kernel in the JAX package either)
    "chorin_fd dst 1024^2": set(),
    "chorin_fd helmholtz multigrid 1024^2": set(),
    "direct_fd exact 1024^2": set(),
    "taylor_green_3d 256^3": {"fused_zy_forward", "fused_lamb"},
    "divergence_max 256^3": {"fused_yz_inverse"},
    # the 2D periodic solver runs cuFFT or cuBLAS GEMMs (the JAX package's
    # spectral_periodic reaches no Pallas kernel either)
    "decaying_turbulence 1024^2 compact default": set(),
    "taylor_green 256^2": set(),
}


def check_rollout(label, path, nt):
    d = np.load(path)
    if "w" in d.files:  # 3D: u, v, w, p of (nt, n, n, n), finite, moving
        for key in "uvwp":
            require(d[key].shape == (nt, N3D, N3D, N3D),
                    f"{label}: {key} has shape {d[key].shape}")
            require(np.isfinite(d[key]).all(), f"{label}: {key} not finite")
        require(float(np.abs(d["u"][-1]).max()) > 0.9, f"{label}: no flow")
        return d
    for key in "uvp":
        require(d[key].shape[0] == nt, f"{label}: {key} has "
                f"{d[key].shape[0]} frames, expected {nt}")
        require(np.isfinite(d[key]).all(), f"{label}: {key} not finite")
    # the lid: u's 'right' Dirichlet edge A[-1, :] is 1 in every frame, bar
    # the two corners that the later 'top'/'bottom' BCs set to 0
    require(np.all(d["u"][:, -1, 1:-1] == 1.0), f"{label}: lid edge != 1")
    require(float(np.abs(d["u"][-1]).max()) > 0, f"{label}: no flow")
    return d


def check_rollout_2d(label, path, nt, n):
    """A 2D periodic rollout: u, v, p of (nt, n, n), finite, moving."""
    d = np.load(path)
    for key in "uvp":
        require(d[key].shape == (nt, n, n),
                f"{label}: {key} has shape {d[key].shape}")
        require(np.isfinite(d[key]).all(), f"{label}: {key} not finite")
    require(float(np.abs(d["u"][-1]).max()) > 0, f"{label}: no flow")
    require(not np.array_equal(d["u"][-1], d["u"][0]),
            f"{label}: the flow did not move")
    return d


def bench_rollout_2d(card: str) -> dict:
    """bench.py's workload through the port: rollout_final_compact of
    decaying turbulence at 1024^2 (compact matmul-DFT, 'default', dt 5e-4,
    nu 1e-4, k_peak 30, seed 0, float32) for BENCH_STEPS steps, timed as
    profile_run times a step loop (median of 3 after a warm-up; one
    profiled rollout for the device's idle share); the final state must be
    finite, as bench.py checks."""
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.solvers import spectral_periodic as sp

    cfg = sp.SpectralPeriodicConfig(nt=BENCH_STEPS, nx=N2D, ny=N2D, dt=5e-4,
                                    nu=1e-4, dtype="float32",
                                    transform="matmul",
                                    matmul_precision="default",
                                    compact_spectrum=True)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=0, k_peak=30.0)
    carry0 = sp.init_from_vorticity_compact(cfg, w0, DEVICE)
    final = []
    r = profile_run.profile_rollout(
        lambda: final.append(sp.rollout_final_compact(cfg, carry0)),
        cfg.nt)
    require(bool(torch.isfinite(torch.view_as_real(final[-1][0])).all()),
            "bench rollout produced a non-finite state")
    rate = r["steps_per_s_median_of_3"]
    out = {"config": "bench.py:36-40 decaying_turbulence 1024^2 compact "
                     "matmul 'default'", "steps": cfg.nt,
           "steps_per_s": rate, "cell_updates_per_s": rate * N2D * N2D,
           "steps_per_s_runs": r["steps_per_s"],
           "device_idle_share": r["device_idle_share"], "card": card}
    print(f"  bench.py's rollout 1024^2: {rate:.1f} steps/s "
          f"({rate * N2D * N2D:.3e} cell-updates/s), device idle "
          f"{r['device_idle_share']:.3f}; {card}")
    return out



def final_state_3d() -> dict:
    """divergence_max and the energies of a 256^3 Taylor-Green final state
    (8 steps), through NavierStokesSystem3D at the main run's config."""
    from ns_tpu_torch.solvers import spectral3d as s3

    kw = dict(nt=8, nx=N3D, ny=N3D, nz=N3D, dt=1e-3, nu=6.25e-4,
              transform="matmul", matmul_precision="default",
              use_pallas_transform="auto")
    cfg = s3.Spectral3DConfig(**kw)
    require(cfg.use_pallas_transform is True, "auto gate resolved off")
    sys_ = s3.NavierStokesSystem3D(s3.taylor_green_velocity(cfg),
                                   device=DEVICE, **kw)
    final = sys_.final_state()
    u_max = float(s3.fields_from_hat(cfg, final[0]).abs().max())
    return {"div": float(s3.divergence_max(cfg, final[0])), "u_max": u_max,
            "e0": float(s3.energy(cfg, sys_.carry0[0])),
            "e8": float(s3.energy(cfg, final[0]))}


def initial_energies_3d() -> dict:
    """E0 of the 256^3 Taylor-Green carry by the plain route at 'default'
    (the same bf16 rounding points as the main run's K6) and by the fused
    route at 'highest' (K6's fp32 kernel), which must give 0.125."""
    from ns_tpu_torch.solvers import spectral3d as s3

    out = {}
    for key, prec, fused in (("e0_plain_default", "default", False),
                             ("e0_highest", "highest", True)):
        kw = dict(nt=1, nx=N3D, ny=N3D, nz=N3D, transform="matmul",
                  matmul_precision=prec, use_pallas_transform=fused)
        cfg = s3.Spectral3DConfig(**kw)
        carry = s3.init_from_velocity(cfg, s3.taylor_green_velocity(cfg),
                                      DEVICE)
        out[key] = float(s3.energy(cfg, carry[0]))
    return out


def phase_main(tmp, card: str) -> dict:
    from ns_tpu_torch.cli import run_solver
    from ns_tpu_torch.ops import kernels

    print("phase 4: main path through ns_tpu_torch.cli.run_solver.main")
    rates, out3d = {}, {}
    kernels.reset_launch_counts()
    tc = [kernels.fused_zy_forward, kernels.fused_yz_inverse,
          kernels.fused_lamb]  # the wrappers with a tensor-core route

    def bf16_counts() -> dict:
        return {w.__name__: w.launches_bf16 for w in tc}

    resident = [getattr(kernels, name) for name in RESIDENT]

    def resident_counts() -> dict:
        return {w.__name__: w.launches_resident for w in resident}

    for label, argv in MAIN_RUNS:
        before = kernels.launch_counts()
        bf16_before = bf16_counts()
        calls_before, resident_before = kernels.call_counts(), \
            resident_counts()
        out = os.path.join(tmp, label.replace(" ", "_").replace("^", "") +
                           ".npz")
        summary = run_solver.main(argv + ["--device", DEVICE, "--out", out])
        after = kernels.launch_counts()
        ran = {k for k in after if after[k] > before[k]}
        missing = MAIN_KERNELS[label] - ran
        require(not missing, f"{label}: kernels not launched: {missing}")
        # the K2mb solves of the direct_fd 1024^2 run and the SOR solves of
        # the 1024^2 (K4) and 1025^2 (K5) runs: every one on the resident
        # route, one launch a solve
        for name in RESIDENT & MAIN_KERNELS[label]:
            solves = kernels.call_counts()[name] - calls_before[name]
            n_res = resident_counts()[name] - resident_before[name]
            require(n_res == solves == after[name] - before[name],
                    f"{label}: {name}'s solves did not all take the resident "
                    f"route ({solves} solves, {after[name] - before[name]} "
                    f"launches, {n_res} resident)")
        if "3d" in label:  # 'default': K6 and K8 take the tensor cores
            bf16 = bf16_counts()
            slow = [k for k in MAIN_KERNELS[label] if bf16[k] == bf16_before[k]]
            require(not slow, f"{label}: no tensor-core launch of {slow}")
        nt = int(argv[argv.index("--nt") + 1]) if "--nt" in argv else 200
        if argv[0] in PERIODIC_2D:
            n = int(argv[argv.index("--nx") + 1]) if "--nx" in argv else 256
            check_rollout_2d(label, out, nt, n)
        else:
            check_rollout(label, out, nt)
        if "3d" in label:
            require(summary["use_pallas_transform"] is True,
                    f"{label}: the auto gate resolved off")
            out3d[label] = out
        rates[label] = summary["steps_per_s"]
        print(f"  {label:36s} {summary['steps_per_s']:.1f} steps/s "
              f"({summary['seconds']:.2f} s); launches "
              f"{ {k: after[k] - before[k] for k in sorted(ran)} }")
    before, bf16_before = kernels.launch_counts(), bf16_counts()
    st = final_state_3d()
    after, bf16 = kernels.launch_counts(), bf16_counts()
    ran = {k for k in after if after[k] > before[k]}
    missing = MAIN_KERNELS["divergence_max 256^3"] - ran
    require(not missing, f"divergence_max: kernels not launched: {missing}")
    require(bf16["fused_yz_inverse"] > bf16_before["fused_yz_inverse"],
            "divergence_max: K7 did not take its tensor-core kernel")
    counts, launches_bf16 = dict(after), bf16
    calls = kernels.call_counts()
    # the carries of the E0 checks, outside the main path's counts
    st.update(initial_energies_3d())
    rel_div = st["div"] / st["u_max"]
    d_e0 = abs(st["e0"] - st["e0_plain_default"])
    print(f"  divergence_max 256^3 after 8 steps {st['div']:.3e} "
          f"({rel_div:.3e} of max|u| {st['u_max']:.4f}; bound 1e-4); "
          f"E0 {st['e0']:.8f} (the plain 'default' route's "
          f"{st['e0_plain_default']:.8f} +- 1e-6: {d_e0:.2e}), E8 "
          f"{st['e8']:.8f} (< E0); E0 at 'highest' {st['e0_highest']:.8f} "
          f"(0.125 +- 1e-5); launches "
          f"{ {k: after[k] - before[k] for k in sorted(ran)} }")
    require(rel_div <= 1e-4, f"divergence {rel_div} > 1e-4 of max|u|")
    require(d_e0 <= 1e-6, f"E0 = {st['e0']} differs from the plain "
            f"'default' route's {st['e0_plain_default']} by {d_e0}")
    require(abs(st["e0_highest"] - 0.125) <= 1e-5,
            f"E0 at 'highest' = {st['e0_highest']} != 0.125")
    require(st["e8"] < st["e0"], f"energy grew: {st['e8']} >= {st['e0']}")
    idle = [k for k, n in counts.items() if n == 0]
    require(not idle, f"kernels never launched on the main path: {idle}")
    bench = bench_rollout_2d(card)
    return {"launches": counts, "launches_bf16": launches_bf16,
            "calls": calls, "launches_resident": resident_counts(),
            "steps_per_s": rates, "tg3d_npz": out3d["taylor_green_3d 256^3"],
            "bench_2d": bench}


# --- phase 5 -----------------------------------------------------------------

def phase_fidelity(tmp):
    from ns_tpu_torch.cli import run_solver

    print("phase 5: float64 fidelity on the card against the goldens")
    cases = [("direct_fd_nt20.npz", ["direct_fd", "--nt", "20"],
              {"u": 1e-10, "v": 1e-10, "p": 1e-10}),
             ("direct_fd_nt200_snapshots.npz", ["direct_fd"],
              {"u": 1e-10, "v": 1e-10, "p": 1e-10}),
             ("chorin_fd_semi_implicit_nt12.npz", ["chorin_fd", "--nt", "12"],
              {"u": 1e-3, "v": 1e-3, "p": 0.2}),
             ("chorin_fd_explicit_nt12.npz",
              ["chorin_fd", "--method", "explicit", "--nt", "12"],
              {"u": 1e-3, "v": 1e-3, "p": 0.2})]
    for golden, argv, bounds in cases:
        out = os.path.join(tmp, "f64_" + golden)
        run_solver.main(argv + ["--dtype", "float64", "--device", DEVICE,
                                "--out", out])
        got, want = np.load(out), np.load(os.path.join(GOLDEN, golden))
        # snapshot goldens hold only the listed frames of the rollout
        frames = want["frames"] if "frames" in want else slice(None)
        for key, bound in bounds.items():
            err = float(np.abs(got[key][frames] - want[key]).max())
            print(f"  {golden:36s} {key} max_abs {err:.3e} (bound {bound:g})")
            require(err <= bound, f"{golden} {key}: {err} > {bound}")


# the FD modes with no kernel of their own, float64 on the card against the
# same rollout through the port on the CPU (which the CPU tests hold against
# ns_tpu): GEMMs sum in another order on cuBLAS, hence 1e-10; MGCG's inner
# products are reductions whose order differs too, and CG carries that
# through its step sizes, hence 1e-8 for the multigrid mode
MODE_RUNS = [
    ("chorin_fd dst", ["chorin_fd", "--pressure-mode", "dst"], 1e-10),
    ("chorin_fd multigrid", ["chorin_fd", "--method", "explicit",
                             "--pressure-mode", "multigrid"], 1e-8),
    ("chorin_fd helmholtz", ["chorin_fd", "--method", "helmholtz"], 1e-10),
    ("direct_fd exact", ["direct_fd", "--pressure-mode", "exact"], 1e-10),
]


def phase_fidelity_modes(tmp):
    from ns_tpu_torch.cli import run_solver
    from ns_tpu_torch.ops import fast_poisson, poisson

    print("phase 5: float64 direct and multigrid modes, card vs CPU")
    for label, argv, bound in MODE_RUNS:
        got = {}
        for dev in (DEVICE, "cpu"):
            out = os.path.join(tmp, f"mode_{dev}_" + label.replace(" ", "_")
                               + ".npz")
            run_solver.main(argv + ["--nt", "10", "--dtype", "float64",
                                    "--device", dev, "--out", out])
            got[dev] = np.load(out)
        for key in "uvp":
            a, b = got[DEVICE][key], got["cpu"][key]
            require(np.isfinite(a).all(), f"{label} {key}: not finite")
            err = float(np.abs(a - b).max())
            print(f"  {label + ' 10 steps':36s} {key} max_abs {err:.3e} "
                  f"(bound {bound:g})")
            require(err <= bound, f"{label} {key}: {err} > {bound}")

    # a float64 dst solve at 1024^2 leaves a 5-point interior residual at
    # rounding level: <= 1e-12 of the scale of the terms the residual
    # cancels (8 max|p| / h^2); a CPU run of this check read 6.7e-15
    n = 1024
    h = 2.0 / (n - 1)
    gen = torch.Generator().manual_seed(3)
    p0, f = (torch.randn((n, n), generator=gen, dtype=torch.float64)
             .to(DEVICE) for _ in range(2))
    p = fast_poisson.make_dst_poisson(n, n, h, h, dtype=torch.float64,
                                      device=DEVICE)(p0, f)
    res = (poisson.laplace_full(p, h * h, h * h) - f)[1:-1, 1:-1]
    rel = float(res.abs().max()) / (8.0 * float(p.abs().max()) / (h * h))
    print(f"  {'1024^2 f64 dst solve: interior residual':36s} {rel:.3e} of "
          f"8 max|p|/h^2 (bound 1e-12)")
    require(rel <= 1e-12, f"dst residual {rel} > 1e-12")


# the 'default'-precision main run against its own plain route, after 8
# steps. Both round at the TPU's DEFAULT points everywhere (bf16 operands,
# fp32 sums and results: the plain route's GEMMs; the x-stage GEMMs and K6,
# K7, K8 on the fused one), so they differ only where an fp32 sum taken in
# another order rounds an intermediate to the other bf16 neighbour, and
# the step carries those one-ulp flips on. Measured on the card (PERF.md):
# u 2.0e-3, v 2.4e-4, w 1.6e-5 of the velocity scale, p 4.0e-3 of max|p|
# (with K8 in fp32 it was u, v 3.9e-3, p 5.0e-3); 2x headroom on p
DEFAULT_VS_PLAIN = 8e-3


# the plain 'high' run against the plain 'highest' run after 8 steps: 'high'
# must meet the TPU's HIGH (bf16x3), where TF32 does not. Read on the card
# in one call (PERF.md; tools/torch_gemm_high_forms.py): a TF32 'high' u
# 1.0e-3, v 1.5e-3, w 1.1e-4, p 1.9e-3; a bf16x3 'high' u 1.7e-5, v
# 1.9e-5, w 1.6e-6, p 3.1e-5; the port's 'high' (fp32) 0 in every field.
# 2x headroom on bf16x3's p: TF32 fails in every field
HIGH_VS_HIGHEST = 6e-5


def tg3d_high_rates() -> dict:
    """The 256^3 Taylor-Green rollout at 'high' (the 3D CLI's default
    precision) with the fused kernels on (K6's 3xTF32 kernel in the carry's
    init, K8's 3xTF32 pair every step) beside off (the plain fp32 GEMM
    route): steps/s of 8 steps of the built step from the carry (median of
    3, in turns on, off, ...; the step's constants are built once, as a
    rollout builds them, outside the timing), and the fused carry's K6
    route."""
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.solvers import spectral3d as s3

    runs, times, k6_tf32 = {}, {True: [], False: []}, 0
    for fused in (True, False):
        cfg = s3.Spectral3DConfig(nt=8, nx=N3D, ny=N3D, nz=N3D, dt=1e-3,
                                  nu=6.25e-4, transform="matmul",
                                  matmul_precision="high",
                                  use_pallas_transform=fused)
        t0 = kernels.fused_zy_forward.launches_tf32
        carry = s3.init_from_velocity(cfg, s3.taylor_green_velocity(cfg),
                                      DEVICE)
        if fused:
            k6_tf32 = kernels.fused_zy_forward.launches_tf32 - t0
        step, _ = s3.make_step(cfg, carry[0].device)
        step(carry)  # warm-up
        runs[fused] = (step, carry)
    n0 = kernels.fused_lamb.launches
    n0_tf32 = kernels.fused_lamb.launches_tf32
    for _ in range(3):
        for fused in (True, False):
            step, c = runs[fused]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                c, _ = step(c)
            torch.cuda.synchronize()
            times[fused].append(time.perf_counter() - t0)
    k8 = kernels.fused_lamb.launches - n0
    k8_tf32 = kernels.fused_lamb.launches_tf32 - n0_tf32
    rate = {k: 8 / float(np.median(v)) for k, v in times.items()}
    label = f"{N3D}^3 TG 8 steps at 'high', steps/s (median of 3)"
    print(f"  {label:44s} fused "
          f"{rate[True]:.1f}, plain {rate[False]:.1f}; K6 3xTF32 launches "
          f"in the fused carry's init {k6_tf32}, K8 launches {k8} (3xTF32 "
          f"{k8_tf32})")
    require(k6_tf32 == 1, "the fused 'high' carry did not take K6's 3xTF32 "
            "kernel once")
    require(k8 == k8_tf32 == 3 * 8, f"the fused 'high' rollouts launched K8 "
            f"{k8} times, its 3xTF32 pair {k8_tf32} times")
    return {"fused_steps_per_s": rate[True], "plain_steps_per_s": rate[False],
            "fused_runs_s": times[True], "plain_runs_s": times[False]}


def phase_fidelity_3d(tmp, main_npz):
    from ns_tpu_torch.cli import run_solver
    from ns_tpu_torch.solvers import spectral3d as s3

    print("phase 5: 3D fidelity on the card")

    def last_frames(argv, name):
        """The state after the main run's 8 steps, saved as the one frame
        of a strided run (frame 0 is the state after 1 + spinup steps):
        256 MB to write and read instead of 2 GB."""
        out = os.path.join(tmp, name)
        run_solver.main(TG3D + argv + ["--nt", "1", "--spinup", "7",
                                       "--device", DEVICE, "--out", out])
        d = np.load(out)
        return {k: d[k][-1] for k in "uvwp"}

    def compare(label, got, want, bound, velocity_scale=False):
        """max|got - want| relative to the field's own max, or, with
        velocity_scale, u/v/w relative to the largest velocity component
        (w starts at 0 and stays ~1e-3 of |u| over 8 steps)."""
        vmax = max(float(np.abs(want[k]).max()) for k in "uvw")
        for key in "uvwp":
            scale = float(np.abs(want[key]).max())
            if velocity_scale and key != "p":
                scale = vmax
            rel = float(np.abs(got[key] - want[key]).max()) / scale
            print(f"  {label:44s} {key} max_rel {rel:.3e} (bound {bound:g})")
            require(rel <= bound, f"{label} {key}: {rel} > {bound}")

    # fused against plain, both at 'highest' (fp32 GEMMs on both sides)
    on = last_frames(["--precision", "highest", "--pallas-transform", "on"],
                     "tg_on.npz")
    off = last_frames(["--precision", "highest", "--pallas-transform", "off"],
                      "tg_off.npz")
    compare("256^3 TG 8 steps: fused vs plain, 'highest'", on, off, 1e-4)
    high = last_frames(["--precision", "high", "--pallas-transform", "off"],
                       "tg_high_off.npz")
    compare("256^3 TG 8 steps: plain 'high' vs 'highest'", high, off,
            HIGH_VS_HIGHEST, velocity_scale=True)
    plain_default = last_frames(["--precision", "default",
                                 "--pallas-transform", "off"],
                                "tg_default_off.npz")
    d = np.load(main_npz)
    main = {k: d[k][-1] for k in "uvwp"}
    compare("256^3 TG 8 steps: main run vs plain, 'default'", main,
            plain_default, DEFAULT_VS_PLAIN, velocity_scale=True)

    # float64 shear flow u = (sin z, 0, 0) on cuFFT: exact exp(-nu t) decay
    cfg = s3.Spectral3DConfig(nt=50, nx=16, ny=16, nz=16, dt=1e-3, nu=0.1,
                              dtype="float64", transform="fft")
    z = 2.0 * np.pi * np.arange(16) / 16
    u0 = np.zeros((3, 16, 16, 16))
    u0[0] = np.sin(z)[None, None, :]
    fin = s3.rollout_final(cfg, s3.init_from_velocity(cfg, u0, DEVICE))
    got = s3.fields_from_hat(cfg, fin[0]).cpu().numpy()
    err = float(np.abs(got - u0 * np.exp(-0.1 * 50 * 1e-3)).max())
    print(f"  {'16^3 f64 shear flow vs exp(-nu t), 50 steps':44s} max_abs "
          f"{err:.3e} (bound 1e-12)")
    require(err <= 1e-12, f"shear flow decay off by {err}")
    return {"tg3d_high": tg3d_high_rates()}


# the float32 1024^2 Taylor-Green run (nu 0.1, dt 1e-3, 100 steps, compact
# matmul-DFT) against the exact decay exp(-2 nu t), max error over max|w0|:
# read on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) 'default' 5.41e-3
# (bf16 inputs: the nonlinear term, zero for this flow, comes out at bf16's
# rounding), 'high' 5.09e-7; bounds with 1.8x and 4x headroom
TG2D_BOUND = {"default": 1e-2, "high": 2e-6}
# 'high' against 'highest' after 20 steps of 1024^2 decaying turbulence: both
# are fp32 GEMMs with TF32 off, so 0; the 3D bound's (HIGH_VS_HIGHEST), which
# a TF32 'high' failed there
HIGH_VS_HIGHEST_2D = 6e-5
# bench.py's engine (compact, 'default') after 20 steps of 1024^2 decaying
# turbulence, card against CPU, max error of each part of the carry over its
# max: both round each GEMM's inputs to bf16 and sum in fp32, the card on its
# tensor cores (batched bf16 GEMMs with bf16 tables), the CPU in fp32 on the
# rounded values. Read on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# w_hat 1.93e-5, N_prev 5.38e-4 (the nonlinear term: a sum taken in another
# order rounds to another bf16 neighbour at the next stage); bounds with
# 5.2x and 3.7x headroom. The control that rounds each GEMM's output to bf16 read 3.27e-3
# and 6.91e-3, 33x and 3.5x above them
DEFAULT_CARD_VS_CPU_2D = {"w_hat": 1e-4, "N_prev": 2e-3}


def default_card_vs_cpu(sp, kw, card_final):
    """bench.py's engine at 'default' on the card against the CPU, on a
    flow whose nonlinear term is not zero; and a control with each bf16
    GEMM's output rounded to bf16 too (the rounding that the TPU's DEFAULT
    does not do), which must read above the bound."""
    from ns_tpu_torch.ops import gemm

    def final(device):
        cfg = sp.SpectralPeriodicConfig(matmul_precision="default", **kw)
        return sp.carry_to_numpy(sp.NavierStokesSystem(
            sp.decaying_turbulence_vorticity(cfg), matmul_precision="default",
            device=device, **kw).final_state())

    def rel(got, want):
        return [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(got, want)]

    cpu = final("cpu")
    errs = rel(sp.carry_to_numpy(card_final), cpu)
    exact_mm = gemm._bf16_mm_f32
    gemm._bf16_mm_f32 = lambda a, b: exact_mm(a, b).bfloat16().float()
    try:
        controls = rel(final(DEVICE), cpu)
    finally:
        gemm._bf16_mm_f32 = exact_mm
    for (part, bound), err, control in zip(DEFAULT_CARD_VS_CPU_2D.items(),
                                           errs, controls):
        label = f"1024^2 f32 default 20 steps: card vs CPU, {part}"
        print(f"  {label:52s} max_rel {err:.3e} (bound {bound:g}); "
              f"control, bf16 GEMM outputs {control:.3e} (must exceed it)")
        require(err <= bound, f"2D default card vs CPU {part}: {err} > "
                f"{bound}")
        require(control > bound, f"2D default control {part}: {control} "
                f"<= {bound}")


def phase_fidelity_2d():
    from ns_tpu_torch.solvers import diffable
    from ns_tpu_torch.solvers import spectral_periodic as sp

    print("phase 5: 2D periodic fidelity on the card")
    # float64 card against CPU, engine for engine: 10 steps at 256^2
    base = dict(nt=10, nx=256, ny=256, dt=5e-4, nu=1e-4, dtype="float64")
    for name, kw in (("fft", dict(transform="fft")),
                     ("compact", dict(transform="matmul",
                                      compact_spectrum=True)),
                     ("real_gemm", dict(transform="matmul",
                                        compact_spectrum=True,
                                        real_gemm=True))):
        cfg = sp.SpectralPeriodicConfig(**base, **kw)
        w0 = sp.decaying_turbulence_vorticity(cfg, seed=1)
        fins = [sp.carry_to_numpy(sp.rollout_final(
            cfg, sp.init_from_vorticity(cfg, w0, dev))) for dev in
            (DEVICE, "cpu")]
        err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(*fins))
        print(f"  {'256^2 f64 10 steps, card vs CPU: ' + name:52s} "
              f"max_rel {err:.3e} (bound 1e-10)")
        require(err <= 1e-10, f"2D {name}: card vs CPU {err} > 1e-10")

    # float32 1024^2 Taylor-Green against exp(-2 nu t)
    tg = dict(nt=100, nx=N2D, ny=N2D, dt=1e-3, nu=0.1, transform="matmul",
              compact_spectrum=True)
    for prec, bound in TG2D_BOUND.items():
        cfg = sp.SpectralPeriodicConfig(matmul_precision=prec, **tg)
        w0 = sp.taylor_green_vorticity(cfg)
        sys_ = sp.NavierStokesSystem(w0, matmul_precision=prec,
                                     device=DEVICE, **tg)
        w = sp.physical_from_carry(cfg, sys_.final_state()[0]).cpu().numpy()
        exact = w0.astype(np.float64) * np.exp(-2.0 * 0.1 * 100 * 1e-3)
        err = float(np.abs(w - exact).max() / np.abs(w0).max())
        print(f"  {'1024^2 f32 TG 100 steps vs exp(-2 nu t), ' + prec:52s} "
              f"max_rel {err:.3e} (bound {bound:g})")
        require(err <= bound, f"2D TG {prec}: {err} > {bound}")

    # decaying turbulence at 1024^2, 20 steps: 'high' vs 'highest', and on
    # the 'default' run divergence_max and the energy's decay
    dt = dict(nt=20, nx=N2D, ny=N2D, dt=5e-4, nu=1e-4, transform="matmul",
              compact_spectrum=True)
    fin = {}
    for prec in ("default", "high", "highest"):
        cfg = sp.SpectralPeriodicConfig(matmul_precision=prec, **dt)
        sys_ = sp.NavierStokesSystem(sp.decaying_turbulence_vorticity(cfg),
                                     matmul_precision=prec, device=DEVICE,
                                     **dt)
        fin[prec] = (cfg, sys_.carry0, sys_.final_state())
    cfg, _, hi = fin["high"]
    _, _, top = fin["highest"]
    w_hi, w_top = (sp.physical_from_carry(cfg, c[0]) for c in (hi, top))
    rel = float((w_hi - w_top).abs().max() / w_top.abs().max())
    print(f"  {'1024^2 f32 20 steps: high vs highest':52s} max_rel "
          f"{rel:.3e} (bound {HIGH_VS_HIGHEST_2D:g})")
    require(rel <= HIGH_VS_HIGHEST_2D, f"2D high vs highest {rel}")
    cfg, c0, c20 = fin["default"]
    default_card_vs_cpu(sp, dt, c20)
    full0, full20 = (sp.expand_compact(cfg, c[0]) for c in (c0, c20))
    u, v, _ = sp.fields_from_hat(cfg, full20)
    umax = float(torch.maximum(u.abs().max(), v.abs().max()))
    div = float(sp.divergence_max(cfg, full20))
    e0, e20 = (float(sp.energy_spectrum(cfg, f)[1].sum())
               for f in (full0, full20))
    print(f"  {'1024^2 f32 default 20 steps: divergence_max':52s} "
          f"{div:.3e} ({div / umax:.3e} of max|u| {umax:.4f}; bound 1e-5); "
          f"E0 {e0:.8e}, E20 {e20:.8e} (< E0)")
    require(div <= 1e-5 * umax, f"2D divergence {div} > 1e-5 max|u|")
    require(e20 < e0, f"2D energy grew: {e20} >= {e0}")

    # diffable: the 64^2 initial-condition fit through the solver, float64
    fit = sp.SpectralPeriodicConfig(nt=10, nx=64, ny=64, dt=0.01, nu=1e-2,
                                    dtype="float64")
    w_true = sp.taylor_green_vorticity(fit)
    fin64 = sp.rollout_final(fit, sp.init_from_vorticity(fit, w_true,
                                                         DEVICE))
    target = torch.fft.irfft2(fin64[0], s=(64, 64))
    # lr 1600: the 16^2 test's 100 scaled by the cell count (the mean-square
    # loss's gradient falls as 1/n^2); the CPU reads 1e-13 of the first
    # loss after 10 iterations
    _, losses = diffable.fit_initial_vorticity(fit, target, nt=10,
                                               n_iters=20, lr=1600.0)
    print(f"  {'64^2 f64 fit_initial_vorticity, 20 iterations':52s} loss "
          f"{losses[0]:.3e} -> {losses[-1]:.3e} (bound 1e-8 of the first)")
    require(losses[-1] <= 1e-8 * losses[0], f"diffable fit: {losses}")


# --- the Chebyshev family (phases 4 and 5) ----------------------------------
# chorin_spectral reaches no Pallas kernel in the JAX package, so the port
# runs it as cuBLAS GEMMs and torch elementwise ops: these phases check the
# path and time it; they launch no kernel of the library (the --progress
# chorin_fd run launches K1 and K3, and must)

CHEB_N = 1024  # the corrected mode's north-star grid
# dt 1e-6: the advective CFL at the lid's smallest Gauss-Lobatto spacing
# (1 - cos(pi/1023) = 4.7e-6) is ~0.2 (PERF.md section 4)
CHEB_1024 = ["chorin_spectral", "--corrected", "--nx", str(CHEB_N), "--nt",
             "20", "--dt", "1e-6"]
# the interior divergence outside the pressure modes that the solver's
# deflation (|lx + ly| <= 1e-8 max) leaves unprojected: the float32 main
# run (CPU reading 9.5, max|div| 25) and a float64 run on the card,
# relative to its max|div| (CPU reading 3.7e-9)
CHEB_DIV_F32 = 50.0
CHEB_DIV_F64_REL = 1e-6


def run_cli(argv):
    """run_solver.main(argv), its output echoed; returns (summary, the
    guard and note lines it printed)."""
    from ns_tpu_torch.cli import run_solver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = run_solver.main(argv)
    text = buf.getvalue()
    print("  " + text.strip().replace("\n", "\n  "))
    return summary, [line for line in text.splitlines()
                     if line.startswith(("guard:", "note:"))]


def guard_step(lines):
    """The step of 'guard: divergence at step N', or None."""
    for line in lines:
        if line.startswith("guard: divergence at step "):
            return int(line.split()[4])
    return None


def phase_main_chebyshev(tmp, card: str) -> dict:
    """The Chebyshev family through the CLI: the reference preset under
    --guard (it must trip, at the float64 CPU run's step), the corrected
    1024^2 run at 'highest' and 'default' under --guard (no trip), its
    step loop by profile_run, and --progress --chunk 4 on a cavity and a
    2D periodic run against their plain runs."""
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.ops import kernels

    print("phase 4: the Chebyshev family, --guard and --progress")
    out = {"rates": {}, "setup_s": {}, "profile": {}}
    path, path_cpu = (os.path.join(tmp, f"cheb51_{d}.npz")
                      for d in ("card", "cpu"))
    before = kernels.launch_counts()
    _, said = run_cli(["chorin_spectral", "--guard", "--device", DEVICE,
                       "--out", path])
    _, said_cpu = run_cli(["chorin_spectral", "--guard", "--dtype",
                           "float64", "--device", "cpu", "--out", path_cpu])
    k, k_cpu = guard_step(said), guard_step(said_cpu)
    require(k is not None and k == k_cpu,
            f"chorin_spectral 51^2 --guard tripped at {k} on the card, "
            f"{k_cpu} in float64 on the CPU")
    d = np.load(path)
    for key in "uvp":
        require(d[key].shape == (200, 51, 51) and np.isfinite(d[key]).all(),
                f"guarded 51^2 {key}: shape {d[key].shape} or not finite")
        frozen = d[key][k - 1] if k > 0 else d[key][0]
        require(all(np.array_equal(f, frozen) for f in d[key][k:]),
                f"guarded 51^2 {key}: not frozen after the trip")
    require(np.all(d["u"][:, -1, 1:-1] == 1.0) or k > 0,
            "guarded 51^2: the frozen initial state lost its lid")
    out["guard_step"] = k
    for prec in ("highest", "default"):
        label = f"chorin_spectral corrected 1024^2 {prec}"
        path = os.path.join(tmp, f"cheb1024_{prec}.npz")
        summary, said = run_cli(CHEB_1024 + ["--guard", "--gemm-precision",
                                             prec, "--device", DEVICE,
                                             "--out", path])
        require(not said, f"{label}: the guard tripped: {said}")
        d = np.load(path)
        for key in "uvp":
            require(d[key].shape == (20, CHEB_N, CHEB_N),
                    f"{label}: {key} has shape {d[key].shape}")
            require(np.isfinite(d[key]).all(), f"{label}: {key} not finite")
        # the lid ('right' = 1) lands on row 0: the reference's descending
        # Gauss-Lobatto coordinate
        require(np.all(d["u"][:, 0, 1:-1] == 1.0), f"{label}: lid != 1")
        require(not np.array_equal(d["v"][-1], d["v"][0]),
                f"{label}: the flow did not move")
        out["rates"][label] = summary["steps_per_s"]
        out["setup_s"][label] = summary["setup_seconds"]
        if prec == "highest":
            out["npz_1024"] = path
    ran = {n for n, c in kernels.launch_counts().items() if c > before[n]}
    require(not ran, f"the Chebyshev runs launched kernels: {ran}")
    for prec in ("highest", "default"):
        r = profile_run.profile(CHEB_1024 + ["--gemm-precision", prec])
        out["profile"][prec] = r
        print(f"  step loop 1024^2 {prec}: "
              f"{r['steps_per_s_median_of_3']:.1f} steps/s (runs "
              f"{', '.join(f'{x:.1f}' for x in r['steps_per_s'])}), "
              f"{r['device_records_per_step']:.1f} device records a step, "
              f"idle {r['device_idle_share']:.3f}, set-up "
              f"{r['setup_s']:.2f} s; top {r['top_device_ms'][:3]}; {card}")
    # --progress --chunk 4 gives the plain run's npz
    for label, argv, kernels_ran in (
            ("chorin_fd explicit 51^2", ["chorin_fd", "--method", "explicit",
                                         "--nt", "20"],
             {"sor_redblack_fused", "momentum_explicit_fused"}),
            ("taylor_green 256^2", ["taylor_green", "--nt", "20"], set())):
        paths = [os.path.join(tmp, f"progress_{i}.npz") for i in range(2)]
        run_cli(argv + ["--device", DEVICE, "--out", paths[0]])
        before = kernels.launch_counts()
        run_cli(argv + ["--progress", "--chunk", "4", "--device", DEVICE,
                        "--out", paths[1]])
        after = kernels.launch_counts()
        missing = kernels_ran - {n for n in after if after[n] > before[n]}
        require(not missing, f"{label} --progress: not launched: {missing}")
        a, b = (np.load(x) for x in paths)
        for key in "uvp":
            require(np.array_equal(a[key], b[key]),
                    f"{label}: --progress {key} differs from the plain run")
        print(f"  {label}: --progress --chunk 4 npz == the plain run's")
    return out


def divergence_split(u, v, n: int):
    """(max|div|, max|div outside the deflated pressure modes|, number of
    deflated modes) of the interior divergence D[1:-1,:] u[:,1:-1] +
    v[1:-1,:] D[1:-1,:]^T, in float64 on the card. The corrected solver
    deflates the Uzawa modes with |lx + ly| <= 1e-8 max (the JAX
    package's rule), so its projection leaves them; every other mode it
    annihilates."""
    from ns_tpu_torch.ops import cheb, parity

    D = torch.as_tensor(cheb.d_matrix(n, quirk_compat=False), device=DEVICE)
    M = cheb.d_matrix(n, False)[1:-1, 1:-1] @ cheb.d_matrix_pn_minus_2(n,
                                                                      False)
    pe = parity.ParityEig(M, "pressure", torch.float64, device=DEVICE)
    p2 = parity.ParityEig2D(pe, pe)
    den = p2.full_recip(p2.denoms(lambda lx, ly: lx + ly))
    keep = den.abs() > 1e-8 * den.abs().max()
    u, v = (torch.as_tensor(a).to(DEVICE, torch.float64) for a in (u, v))
    div = D[1:-1, :] @ u[:, 1:-1] + v[1:-1, :] @ D[1:-1, :].T
    G = pe.forward(pe.forward(div, -2), -1)
    res = pe.inverse(pe.inverse(G * keep, -1), -2)
    return (float(div.abs().max()), float(res.abs().max()),
            int((~keep).sum()))


def phase_fidelity_chebyshev(npz_1024: str):
    from ns_tpu_torch.cli import run_solver, sanity
    from ns_tpu_torch.solvers import chorin_spectral as cs

    print("phase 5: the Chebyshev family on the card")
    u_bc, v_bc, _ = run_solver.cavity_bcs(0.04, 0.04)
    z = np.zeros((51, 51))
    # 1. float64 51^2 against the goldens, at the JAX tests' bounds
    kw = dict(nit=200, nx=51, ny=51, dt=0.001, rho=1, nu=0.1, beta=1.25,
              device=DEVICE)
    u, v, p = (a.cpu().numpy() for a in cs.NavierStokesSystem(
        z, z, z, u_bc, v_bc, nt=3, **kw).simulate())
    g = np.load(os.path.join(GOLDEN, "chorin_spectral_nt3.npz"))
    p_scale = np.abs(g["p"][0]).max()
    errs = {"p": np.abs(p[0] - g["p"][0]).max() / p_scale}
    for key, a in (("u", u), ("v", v)):
        errs[key] = np.abs(a[0] - g[key][0]).max() / (0.001 * p_scale)
    growth = [float(np.abs(u[t]).max() / np.abs(g["u"][t]).max())
              for t in (1, 2)]
    print(f"  {'chorin_spectral_nt3.npz step 0':36s} p rel {errs['p']:.3e} "
          f"(bound 1e-11), u {errs['u']:.3e} v {errs['v']:.3e} of dt*|p| "
          f"(bound 1e-7); |u| growth vs golden steps 1-2 {growth}")
    require(errs["p"] < 1e-11 and errs["u"] < 1e-7 and errs["v"] < 1e-7
            and all(0.1 < x < 10.0 for x in growth),
            f"chorin_spectral_nt3 golden: {errs}, growth {growth}")
    seqs = cs.NavierStokesSystem(z, z, z, u_bc, v_bc, nt=6,
                                 deflate_pressure_nullspace=True,
                                 **kw).simulate()
    g = np.load(os.path.join(GOLDEN, "chorin_spectral_deflated_nt6.npz"))
    worst = max(float(np.abs(a.cpu().numpy()[t] - g[key][t]).max()
                      / np.abs(g[key][t]).max())
                for a, key in zip(seqs, "uvp") for t in range(6))
    print(f"  {'chorin_spectral_deflated_nt6.npz':36s} max rel {worst:.3e} "
          f"(bound 5e-11)")
    require(worst < 5e-11, f"chorin_spectral_deflated_nt6: {worst}")
    # 2. the corrected engines, float64 256^2, card against CPU, 10 steps
    n = 256
    bcs = run_solver.cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))[:2]
    z = np.zeros((n, n))
    for engine, ekw in (("dense", dict(parity_split=False)),
                        ("composed", dict(parity_split=True)),
                        ("quadrant", dict(parity_split=True,
                                          parity_eig_form="quadrant"))):
        cfg = cs.ChorinSpectralConfig(nt=10, nx=n, ny=n, dt=1e-4, nu=0.1,
                                      quirk_compat=False,
                                      deflate_pressure_nullspace=True, **ekw)
        runs = []
        for dev in (DEVICE, "cpu"):
            step = cs.make_step(cfg, *bcs, device=dev)
            runs.append(cs.simulate(cfg, cs.init_state(cfg, z, z, z, *bcs,
                                                       device=dev), step))
        err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(*runs))
        print(f"  {'256^2 f64 10 steps, card vs CPU: ' + engine:52s} "
              f"max_rel {err:.3e} (bound 1e-10)")
        require(err <= 1e-10, f"chorin_spectral {engine}: card vs CPU {err}")
    # 3. cached against plain on the card, 1024^2 float32, 5 steps
    n = CHEB_N
    bcs = run_solver.cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))[:2]
    z = np.zeros((n, n))
    cfg = cs.ChorinSpectralConfig(nt=5, nx=n, ny=n, dt=1e-6, nu=0.1,
                                  quirk_compat=False,
                                  deflate_pressure_nullspace=True)
    step = cs.make_step(cfg, *bcs, dtype=torch.float32, device=DEVICE)
    s0 = cs.init_state(cfg, z, z, z, *bcs, dtype=torch.float32,
                       device=DEVICE)
    plain, cached = s0, (s0, step.seed(s0))
    for _ in range(5):
        plain, cached = step(plain), step.cached(*cached)
    same = all(torch.equal(getattr(plain, k), getattr(cached[0], k))
               for k in ("u", "v", "p", "u_prev", "v_prev"))
    print(f"  {'1024^2 f32 5 steps: cached vs plain step':52s} "
          f"{'bitwise equal' if same else 'DIFFERENT'}")
    require(same, "chorin_spectral 1024^2: the cached step is not bitwise "
            "the plain step")
    # 4. the 1024^2 run's interior divergence
    d = np.load(npz_1024)
    dmax, res, n_defl = divergence_split(d["u"][-1], d["v"][-1], n)
    print(f"  {'1024^2 f32 main run: divergence':52s} max {dmax:.3e}; "
          f"outside the {n_defl} deflated modes {res:.3e} (bound "
          f"{CHEB_DIV_F32:g}, headroom {CHEB_DIV_F32 / res:.1f}x)")
    require(res <= CHEB_DIV_F32, f"1024^2 f32 divergence {res}")
    seqs = cs.simulate(cfg, cs.init_state(cfg, z, z, z, *bcs,
                                          device=DEVICE),
                       cs.make_step(cfg, *bcs, device=DEVICE))
    dmax, res, _ = divergence_split(seqs[0][-1], seqs[1][-1], n)
    print(f"  {'1024^2 f64 5 steps: divergence':52s} max {dmax:.3e}; "
          f"outside the deflated modes {res:.3e} = {res / dmax:.3e} of it "
          f"(bound {CHEB_DIV_F64_REL:g}, headroom "
          f"{CHEB_DIV_F64_REL * dmax / res:.0f}x)")
    require(res <= CHEB_DIV_F64_REL * dmax, f"1024^2 f64 divergence {res}")
    # 5. the operators' sanity CLI
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sanity.main([])
    print("  cli.sanity: " + buf.getvalue().strip().splitlines()[-1])
    require("all checks passed" in buf.getvalue(), "cli.sanity failed")


# --- the 2D surrogates and their serving path (phases 4 and 5) -------------
# The JAX models, engine and evaluation reach no Pallas kernel, so the port
# runs them as cuBLAS GEMMs, cuFFT transforms and torch elementwise ops:
# these phases serve a full-width fno_w checkpoint, time it and hold it to
# the CPU, the JAX tests' engine bound and its own physics; they launch no
# kernel of the library.

# fno_w at 128^2, width 64, modes 43 (the full dealiased band), depth 4:
# the configuration that cleared the surrogate target at 128^2 (RESULTS.md
# "Scaling the showcase to 128^2", width 64 row), at the CLI's defaults
# (transform 'auto' -> matmul, fno_dealias, precision None)
SURROGATE = dict(n=128, width=64, modes=43, steps=200, batch=8, chunk=64,
                 repeats=3)
# the families held card against CPU in float64 (small widths), <= 1e-10
FAMILY_N, FAMILY_F64 = 32, 1e-10
SURR_CARD_VS_CPU = 1e-4   # float32, the first 8 steps at B=2, of max|u|
SURR_DIV = 1e-5           # spectral divergence of the reply, of max|u|
SURR_EVAL = 1e-5          # cli.evaluate card vs CPU, relative


def fno_w_checkpoint(folder: str):
    """Write a fno_w checkpoint at the SURROGATE configuration, drawn from
    np.random.default_rng(0) with the JAX init's distributions (dense
    uniform(+-1/sqrt(in)), spectral N(0, 1)/width^2), as the JAX Trainer
    writes it: {"params", "opt_state": {}} with meta config and grid.
    Returns (path, config)."""
    import dataclasses

    from ns_tpu_torch.models.layers import Dense
    from ns_tpu_torch.train.checkpoint import jax_key, save_checkpoint
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    n = SURROGATE["n"]
    cfg = TrainConfig(model="fno_w", fno_width=SURROGATE["width"],
                      fno_modes=SURROGATE["modes"])
    model = build_model(cfg, n, n, device="meta")
    rng = np.random.default_rng(0)
    flat = {}
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, Dense):
            bound = 1.0 / math.sqrt(owner.in_dim)
            a = rng.uniform(-bound, bound, tuple(p.shape))
        else:
            a = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            a /= cfg.fno_width ** 2
        flat[jax_key(name)] = a.astype(np.float32)
    path = save_checkpoint({"params": flat, "opt_state": {}}, folder,
                           meta={"config": dataclasses.asdict(cfg),
                                 "grid": [n, n]})
    return path, cfg


def turbulence_frames(seeds, device, n=None) -> np.ndarray:
    """(len(seeds), 3, n, n) float32 decaying-turbulence (u, v, p) states
    of the port's spectral solver (k_peak n/12, tools/bench_surrogates.py:
    112; n: SURROGATE's grid unless given)."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = n or SURROGATE["n"]
    cfg = sp.SpectralPeriodicConfig(nx=n, ny=n)
    out = []
    for s in seeds:
        w0 = sp.decaying_turbulence_vorticity(cfg, seed=s, k_peak=n / 12)
        w_hat = torch.fft.rfft2(torch.as_tensor(w0, device=device))
        u, v, _ = sp.fields_from_hat(cfg, w_hat)
        p = sp.pressure_from_hat(cfg, w_hat)
        out.append(torch.stack([u, v, p]).cpu().numpy())
    return np.stack(out).astype(np.float32)


def spectral_divergence(reply: np.ndarray) -> float:
    """max|div (u, v)| / max|u| of a (..., 3, n, n) reply, exact spectral
    definition in float64 on the card."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = reply.shape[-1]
    u, v = (torch.as_tensor(reply[..., i, :, :], device=DEVICE)
            .to(torch.float64) for i in (0, 1))
    kx = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64,
                           device=DEVICE)[:, None]
    ky = torch.fft.rfftfreq(n, 1.0 / n, dtype=torch.float64, device=DEVICE)
    div = sp.irfft2(sp._ik_mul(kx, torch.fft.rfft2(u))
                    + sp._ik_mul(ky, torch.fft.rfft2(v)), (n, n))
    return float(div.abs().max() / u.abs().max())


def serve_rate(engine, x: np.ndarray, n_steps: int, repeats: int,
               batch: int) -> dict:
    """Latency of `repeats` predict(x, n_steps) requests of `batch` states
    after one warm-up request: p50 seconds and frames/s (B * n_steps /
    p50)."""
    engine.predict(x, n_steps)
    lat = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(x, n_steps)
        lat.append(time.perf_counter() - t0)
    p50 = sorted(lat)[len(lat) // 2]
    return {"p50_s": p50, "latency_s": lat,
            "frames_per_s": batch * n_steps / p50}


def family_checks_f64() -> float:
    """Each 2D family in float64 at FAMILY_N^2 (small widths), the card
    against the CPU from the same parameters and inputs: the rollout of
    every FNO family at both engines (fno_w with its (u, v, p) recovery),
    the basis solves and rnn's closed loop. Returns the worst error
    relative to each output's max."""
    import dataclasses

    from ns_tpu_torch.models.vorticity import uvp_from_w
    from ns_tpu_torch.train.trainer import (TrainConfig, build_model,
                                            rollout_post)

    n, worst = FAMILY_N, 0.0
    gen = torch.Generator().manual_seed(0)
    grid0 = torch.randn(2, 3, n, n, generator=gen, dtype=torch.float64)
    for model in ("basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv",
                  "rnn", "fno", "fno_w", "fno_psi"):
        for transform in (("fft", "matmul") if model.startswith("fno")
                          else ("auto",)):
            cfg = TrainConfig(model=model, n_coeffs=3, hidden_dim=32,
                              fno_width=8, fno_modes=n // 3 + 1,
                              fno_transform=transform)
            torch.manual_seed(1)
            cpu = build_model(cfg, n, n).double()
            with torch.no_grad():  # spectral weights at scale 1
                for name, p in cpu.named_parameters():
                    if name.startswith("spectral."):
                        p.mul_(cfg.fno_width ** 2)
            card = build_model(cfg, n, n).double().to(DEVICE)
            card.load_state_dict(cpu.state_dict())
            post = rollout_post(cfg)

            def run(m, x):
                if model == "rnn":
                    return m.extrapolate(x.reshape(2, -1), 4)
                if not model.startswith("fno"):
                    return m(x, 5)
                if model == "fno_w":
                    x = x[:, :1]
                xs = m.rollout(x, 3, post=post)
                return (torch.stack(uvp_from_w(xs[:, :, 0]), dim=2)
                        if model == "fno_w" else xs)

            with torch.inference_mode():
                want = run(cpu, grid0)
                got = run(card, grid0.to(DEVICE)).cpu()
            err = float((got - want).abs().max() / want.abs().max())
            require(bool(torch.isfinite(got).all()) and err <= FAMILY_F64,
                    f"{model} {transform} f64 {n}^2 card vs CPU: {err:.3e} "
                    f"(bound {FAMILY_F64})")
            worst = max(worst, err)
    return worst


def fft_vs_matmul_card() -> float:
    """The two spectral engines on the card with random complex weights
    (the mixed spectrum is not Hermitian), float32, at the JAX test's
    shapes (tests/test_fno.py:134-149, rtol 2e-4, atol 1e-5) and at the
    main path's (B=8, width 64, 128^2, modes 43; weights N(0, 1)/width so
    the output is O(1)). Returns the worst |diff| / (atol + rtol |want|)."""
    from ns_tpu_torch.models.fno import (SpectralWeights, _spectral_conv_fft,
                                         _spectral_conv_matmul)

    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    n = SURROGATE["n"]
    cases = [(2, 4, 16, 16, 5, 0.1), (2, 4, 17, 15, 5, 0.1),
             (2, 4, 16, 18, 8, 0.1), (2, 4, 16, 16, 9, 0.1),
             (2, 4, 32, 32, 16, 0.1),
             (SURROGATE["batch"], SURROGATE["width"], n, n,
              SURROGATE["modes"], 1.0 / SURROGATE["width"])]
    for b, c, nx, ny, modes, scale in cases:
        mx, my = min(modes, nx // 2), min(modes, ny // 2 + 1)
        s = SpectralWeights(c, c, mx, my, scale, generator=gen)
        W = s.mixing_table(torch.float32).detach().to(DEVICE)
        x = torch.randn(b, c, nx, ny, generator=gen).to(DEVICE)
        a = _spectral_conv_fft(W, x, mx, my)
        m = _spectral_conv_matmul(W, x, mx, my)
        r = float(((a - m).abs() / (1e-5 + 2e-4 * m.abs())).max())
        shape = (b, c, nx, ny, modes)
        require(r <= 1.0, f"fft vs matmul on the card at {shape}: {r:.3f} "
                "of the bound rtol 2e-4 atol 1e-5")
        worst = max(worst, r)
    return worst


def evaluate_card_vs_cpu(tmp, ckpt: str) -> float:
    """cli.evaluate --ckpt --physics --json on the card and with --device
    cpu, on a short 128^2 decaying-turbulence rollout of the port's
    solver: every number finite, within SURR_EVAL relative (the divergence
    maxima, which are rounding noise, within SURR_DIV of max|u|). Returns
    the worst relative difference."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = SURROGATE["n"]
    cfg = sp.SpectralPeriodicConfig(nx=n, ny=n, dt=5e-3, nu=1e-3)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=1, k_peak=n / 12)
    u, v, p = sp.simulate_strided(cfg, w0, 9, stride=4, device=DEVICE)
    npz = os.path.join(tmp, "surrogate_obs.npz")
    np.savez(npz, u=u.cpu().numpy(), v=v.cpu().numpy(), p=p.cpu().numpy())
    return evaluate_on_both(tmp, ckpt, npz, float(u.abs().max()),
                            "cli.evaluate")


def evaluate_on_both(tmp, ckpt: str, npz: str, umax: float,
                     what: str) -> float:
    """cli.evaluate --ckpt --physics --json on the card and with --device
    cpu: every number of the card's report finite, the divergence maxima
    within SURR_DIV * umax of the CPU's, every other number within
    SURR_EVAL relative. Returns the worst relative difference."""
    from ns_tpu_torch.cli import evaluate

    reports = []
    for device in (DEVICE, "cpu"):
        out = os.path.join(tmp, f"eval_{device}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate.main(["--ckpt", ckpt, "--npz-path", npz, "--physics",
                           "--json", out, "--device", device])
        with open(out) as f:
            reports.append(json.load(f))
    worst = 0.0

    def walk(a, b, key=""):
        nonlocal worst
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], k)
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y, key)
        elif isinstance(b, float):
            require(math.isfinite(a), f"{what} on the card: {key} is {a}")
            if key.startswith("divergence_max"):
                require(abs(a - b) <= SURR_DIV * umax,
                        f"{what} {key}: card {a:.3e}, CPU {b:.3e}")
            else:
                worst = max(worst, abs(a - b) / max(abs(b), 1e-30))

    walk(*reports)
    require(worst <= SURR_EVAL, f"{what} card vs CPU: {worst:.3e} "
            f"relative (bound {SURR_EVAL})")
    return worst


def phase_surrogate(tmp, card: str) -> dict:
    """Serve the SURROGATE fno_w checkpoint on the card through
    InferenceEngine.from_checkpoint (B = 1 and B = 8, 200 steps; a profiled
    chunk; fft and matmul forced), and hold it: finite, solenoidal, card
    against CPU, each family in float64, fft against matmul, cli.evaluate
    card against CPU."""
    import dataclasses

    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.serve import InferenceEngine
    from ns_tpu_torch.serve.engine import load_checkpoint_params
    from ns_tpu_torch.train.trainer import build_model

    print("phase 4/5: the 2D surrogates and their serving path")
    n, steps, b = SURROGATE["n"], SURROGATE["steps"], SURROGATE["batch"]
    t0 = time.perf_counter()
    ckpt, cfg = fno_w_checkpoint(os.path.join(tmp, "fno_w_128"))
    x8 = turbulence_frames(range(b), DEVICE)
    setup = time.perf_counter() - t0
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(ckpt, chunk=SURROGATE["chunk"],
                                             device=DEVICE)
    load = time.perf_counter() - t0
    out = {"config": {"model": "fno_w", "grid": [n, n],
                      "width": cfg.fno_width, "modes": cfg.fno_modes,
                      "depth": 4, "transform": engine.models[0].transform,
                      "precision": cfg.fno_precision, "steps": steps,
                      "chunk": SURROGATE["chunk"]},
           "setup_s": setup, "load_s": load, "device": card}
    engine.warmup(SURROGATE["chunk"])
    engine.warmup(SURROGATE["chunk"], batch=b)
    out["b1"] = serve_rate(engine, x8[0], steps, SURROGATE["repeats"], 1)
    out["b8"] = serve_rate(engine, x8, steps, SURROGATE["repeats"], b)
    reply = engine.predict(x8, steps)
    require(reply.shape == (b, steps + 1, 3, n, n),
            f"fno_w reply shape {reply.shape}")
    require(bool(np.isfinite(reply).all()), "fno_w reply not finite")
    require(bool(np.isfinite(engine.predict(x8[0], steps)).all()),
            "fno_w B=1 reply not finite")
    out["divergence_rel"] = spectral_divergence(reply)
    out["divergence_rel_request"] = spectral_divergence(x8)
    require(out["divergence_rel"] <= SURR_DIV,
            f"fno_w reply divergence {out['divergence_rel']:.3e} of "
            f"max|u| (bound {SURR_DIV})")
    ran = {k for k, c in kernels.launch_counts().items() if c > before[k]}
    require(not ran, f"the surrogate path launched kernels: {ran}")
    for label, x in (("b1", x8[0]), ("b8", x8)):
        r = profile_run.profile_rollout(
            lambda x=x: engine.predict(x, SURROGATE["chunk"]),
            SURROGATE["chunk"])
        out["profile_" + label] = {k: r[k] for k in (
            "steps_per_s_median_of_3", "device_idle_share",
            "device_records_per_step", "device_busy_ms", "profiled_wall_ms",
            "top_device_ms", "top_host_self_ms")}
    # the B=8 request with each spectral engine forced, in turns
    engines = {}
    for transform in ("fft", "matmul"):
        cfg_t = dataclasses.replace(cfg, fno_transform=transform)
        m = build_model(cfg_t, n, n, device="meta").to_empty(device=DEVICE)
        engines[transform] = InferenceEngine(
            cfg_t, [load_checkpoint_params(ckpt, m)], n, n,
            chunk=SURROGATE["chunk"], device=DEVICE)
    rates = {t: [] for t in engines}
    for t in engines:
        engines[t].warmup(SURROGATE["chunk"], batch=b)
    for t in ("fft", "matmul", "matmul", "fft"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[t].predict(x8, steps)
        rates[t].append(time.perf_counter() - t0)
    out["engines_b8"] = {t: {"latency_s": r, "frames_per_s":
                             [b * steps / s for s in r]}
                         for t, r in rates.items()}
    a = engines["fft"].predict(x8[:2], 8)
    m = engines["matmul"].predict(x8[:2], 8)
    out["fft_vs_matmul_rollout"] = float(np.abs(a - m).max()
                                         / np.abs(m).max())
    del engines
    # card against CPU, float32, the first 8 steps at B = 2
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    want = cpu.predict(x8[:2], 8)
    got = engine.predict(x8[:2], 8)
    out["card_vs_cpu_f32"] = float(np.abs(got - want).max()
                                   / np.abs(want[:, :, 0]).max())
    require(out["card_vs_cpu_f32"] <= SURR_CARD_VS_CPU,
            f"fno_w f32 card vs CPU {out['card_vs_cpu_f32']:.3e} of max|u| "
            f"(bound {SURR_CARD_VS_CPU})")
    del cpu
    out["families_f64"] = family_checks_f64()
    out["fft_vs_matmul_of_bound"] = fft_vs_matmul_card()
    out["evaluate_rel"] = evaluate_card_vs_cpu(tmp, ckpt)
    s = engine.stats()
    out["stats"] = {k: s[k] for k in ("requests", "steps_served",
                                      "latency_s")}
    for label in ("b1", "b8"):
        r, pr = out[label], out["profile_" + label]
        print(f"  fno_w {n}^2 w{cfg.fno_width} m{cfg.fno_modes} "
              f"{label.upper()}: {r['frames_per_s']:.1f} frames/s, p50 "
              f"{r['p50_s'] * 1e3:.1f} ms a {steps}-step request; chunk "
              f"profile {pr['steps_per_s_median_of_3']:.1f} steps/s, idle "
              f"{pr['device_idle_share']:.3f}, "
              f"{pr['device_records_per_step']:.1f} device records a step; "
              f"top {pr['top_device_ms'][:3]}; {card}")
    for t, r in out["engines_b8"].items():
        print(f"  B=8 forced {t}: frames/s "
              f"{', '.join(f'{v:.1f}' for v in r['frames_per_s'])}")
    print(f"  checks: divergence {out['divergence_rel']:.2e} of max|u| "
          f"(the request's own {out['divergence_rel_request']:.2e}); "
          f"card vs CPU f32 {out['card_vs_cpu_f32']:.2e}; families f64 "
          f"{out['families_f64']:.2e}; fft vs matmul "
          f"{out['fft_vs_matmul_of_bound']:.3f} of the bound (rollout "
          f"{out['fft_vs_matmul_rollout']:.2e}); cli.evaluate "
          f"{out['evaluate_rel']:.2e}")
    return out


# --- training (phases 4 and 5) ------------------------------------------------
# The JAX trainer reaches no Pallas kernel (its models are plain XLA); its
# data step does: chorin_fd's semi-implicit solver runs K1 at 51^2. The
# phase runs the reference pipeline (data, cli.train, cli.evaluate) and
# trains the full-width fno_w on the card, then holds the objective, the
# gradients and the optimizer's resume to the CPU, to float64 and to
# themselves.

# fno_w at 128^2, width 64, modes 43, depth 4, full batch on the 99 windows
# of 100 frames of decaying turbulence (tools/bench_surrogates.py --nx 128:
# dt 1e-3, nu 1e-3, k_peak n/12, 100 solver steps a frame), float32 at
# precision None, 'auto' -> matmul, dealias on
TRAIN = dict(n=128, width=64, modes=43, frames=100, stride=100, iters=20,
             chunk=10, basis_iters=20)
GRAD_F64 = 1e-10     # objective and gradient, card vs CPU, float64
GRAD_F32 = 2e-5      # float32 gradient at None vs float64, of max|grad|
# 'default' gradient vs its float64 emulation, relative L2 over every
# gradient: the bf16 backward reads 4.3e-5 and a backward that rounds
# nothing 1.5e-4, on the card and on the CPU alike (PERF.md)
GRAD_DEFAULT = 8e-5


def training_data(tmp) -> str:
    """TRAIN's decaying-turbulence rollout of the port's solver as an npz
    of (u, v, p) (frames, n, n)."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = TRAIN["n"]
    cfg = sp.SpectralPeriodicConfig(nx=n, ny=n, dt=1e-3, nu=1e-3)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=0, k_peak=n / 12)
    u, v, p = sp.simulate_strided(cfg, w0, TRAIN["frames"],
                                  stride=TRAIN["stride"], device=DEVICE)
    path = os.path.join(tmp, "turbulence_128.npz")
    np.savez(path, u=u.cpu().numpy(), v=v.cpu().numpy(), p=p.cpu().numpy())
    return path


def reference_pipeline(tmp) -> dict:
    """run_solver chorin_fd --method semi_implicit (51^2, the reference
    preset; K1), cli.train basis_ode K=10 on its first 100 frames
    (RESULTS.md's head-to-head protocol, iterations cut), cli.evaluate
    --ckpt; every file the JAX CLI writes, s/iteration from one timed
    chunk of 10 more iterations."""
    from ns_tpu_torch.cli import evaluate, run_solver, train
    from ns_tpu_torch.ops import kernels

    npz = os.path.join(tmp, "data_semi_implicit.npz")
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        run_solver.main(["chorin_fd", "--method", "semi_implicit",
                         "--device", DEVICE, "--out", npz])
    k1 = kernels.launch_counts()["sor_redblack_fused"]
    require(k1 > 0, "the data step launched no K1")
    out_dir = os.path.join(tmp, "basis_ode")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tr = train.main(["--model", "basis_ode", "--n-coeffs", "10",
                         "--n-frames", "100", "--npz-path", npz,
                         "--n-iters", str(TRAIN["basis_iters"]),
                         "--out-dir", out_dir, "--device", DEVICE])
    cli_s = time.perf_counter() - t0
    ck = out_dir + "_10"
    files = sorted(os.listdir(ck))
    want = ["checkpoint.npz", "checkpoint.npz.meta.json",
            "extrapolation.npy", "metrics.jsonl"]
    require(files == want, f"cli.train wrote {files}, not {want}")
    with open(os.path.join(ck, "checkpoint.npz.meta.json")) as f:
        meta = json.load(f)
    require(meta["iter"] == TRAIN["basis_iters"]
            and len(meta["losses"]) == TRAIN["basis_iters"]
            and meta["grid"] == [51, 51] and meta["noise_key"] is None,
            f"basis_ode meta: {sorted(meta)}")
    extrap = np.load(os.path.join(ck, "extrapolation.npy"))
    require(extrap.shape == (200, 3, 51, 51) and np.isfinite(extrap).all(),
            f"basis_ode extrapolation {extrap.shape}")
    losses = meta["losses"]
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
            f"basis_ode losses {losses[0]} -> {losses[-1]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_chunk(10)
    torch.cuda.synchronize()
    s_it = (time.perf_counter() - t0) / 10
    rep = os.path.join(tmp, "basis_eval.json")
    with contextlib.redirect_stdout(io.StringIO()):
        evaluate.main(["--ckpt", ck, "--npz-path", npz, "--json", rep,
                       "--device", DEVICE])
    with open(rep) as f:
        report = json.load(f)
    rel = {k: w["rel_l2"] for k, w in report["windows"].items()}
    require(set(rel) == {"train", "extrapolation", "full"}
            and all(map(math.isfinite, rel.values())),
            f"cli.evaluate windows: {rel}")
    return {"k1_launches": k1, "cli_s": cli_s, "s_per_iter": s_it,
            "losses": losses, "penalty_last": meta["penalties"][-1],
            "rel_l2": rel}


def fno_w_config(npz: str, out_dir: str, **kw):
    from ns_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(model="fno_w", npz_path=npz, out_dir=out_dir,
                       fno_width=TRAIN["width"], fno_modes=TRAIN["modes"],
                       n_frames=TRAIN["frames"],
                       n_iters=TRAIN["iters"], ckpt_every=TRAIN["chunk"],
                       **kw)


def train_full_width(tmp, npz: str) -> dict:
    """fno_w at TRAIN's configuration: 20 iterations in chunks of 10 (peak
    memory, finite falling losses, no library kernel, no host sync inside
    a chunk), 10 + a resume of 10 against the 20 bitwise, then one
    profiled chunk (it/s, idle share, device records an iteration)."""
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.train.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(fno_w_config(npz, os.path.join(tmp, "fno_w")),
                 device=DEVICE)
    setup = time.perf_counter() - t0
    before = kernels.launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        losses = tr.train()
    ran = {k for k, c in kernels.launch_counts().items() if c > before[k]}
    require(not ran, f"the training chunks launched kernels: {ran}")
    peak = torch.cuda.max_memory_allocated()
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
            f"fno_w losses {losses[0]} -> {losses[-1]}")
    params = {k: v.detach().clone() for k, v in tr.params.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_chunk(TRAIN["chunk"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prof = profile_run.profile_rollout(
        lambda: tr.train_chunk(TRAIN["chunk"]), TRAIN["chunk"])
    del tr
    # 10 iterations, a resume of 10: the same bits as the 20 above
    half = fno_w_config(npz, os.path.join(tmp, "fno_w_half"))
    with contextlib.redirect_stdout(io.StringIO()):
        Trainer(dataclasses.replace(half, n_iters=TRAIN["chunk"]),
                device=DEVICE).train()
        tr = Trainer(dataclasses.replace(
            half, resume=os.path.join(half.out_dir, "checkpoint.npz")),
            device=DEVICE)
        resumed = tr.train()
    worst = max(float((tr.params[k].detach() - params[k]).abs().max())
                for k in params)
    del tr, params
    return {"setup_s": setup, "losses": losses, "peak_gb": peak / 1e9,
            "resume_losses_equal": resumed == losses,
            "resume_params_max_abs": worst,
            "profile": {k: prof[k] for k in (
                "steps_per_s_median_of_3", "steps_per_s", "device_idle_share",
                "device_records_per_step", "device_busy_ms",
                "profiled_wall_ms", "top_device_ms", "top_host_self_ms")}}


def loss_and_grads(cfg, model, obs):
    """The port's objective of `cfg` (full batch, no noise) and every
    parameter's gradient on `model`'s device."""
    from ns_tpu_torch.train.metrics import l2_loss
    from ns_tpu_torch.train.trainer import build_forward, training_tensors

    frames, _ = training_tensors(cfg, obs)
    loss = l2_loss(*build_forward(cfg, frames)(model))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def grad_error(got: dict, want: dict) -> float:
    """max |got - want| over every parameter's gradient, of max|want|."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[k].double().cpu() - want[k].double().cpu())
                     .abs().max()) for k in want) / scale


def grad_error_l2(got: dict, want: dict) -> float:
    """|got - want| / |want|, L2 over every parameter's gradient."""
    sq = lambda t: float((t.double().cpu() ** 2).sum())  # noqa: E731
    return math.sqrt(sum(sq(got[k] - want[k].to(got[k].device))
                         for k in want) / sum(map(sq, want.values())))


def families_grad_f64() -> float:
    """Each 2D training family in float64 at 32^2 (small widths), the
    objective and its gradient on the card against the CPU from the same
    parameters and data, both FNO engines. Returns the worst error."""
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    n, worst = 32, 0.0
    gen = torch.Generator().manual_seed(0)
    obs = torch.randn(6, 1, 3, n, n, generator=gen, dtype=torch.float64)
    for model in ("basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv",
                  "rnn", "fno", "fno_w", "fno_psi"):
        for transform in (("fft", "matmul") if model.startswith("fno")
                          else ("auto",)):
            cfg = TrainConfig(model=model, n_coeffs=3, hidden_dim=32,
                              fno_width=8, fno_modes=n // 3 + 1,
                              fno_transform=transform,
                              fno_rollout_steps=2 if model == "fno" else 1)
            cpu = build_model(cfg, n, n, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(1))
            card = build_model(cfg, n, n, dtype=torch.float64,
                               device="meta").to_empty(device=DEVICE)
            card.load_state_dict(cpu.state_dict())
            lw, gw = loss_and_grads(cfg, cpu, obs)
            lg, gg = loss_and_grads(cfg, card, obs.to(DEVICE))
            err = max(abs(float(lg) - float(lw)) / abs(float(lw)),
                      grad_error(gg, gw))
            require(err <= GRAD_F64, f"{model} {transform} f64 objective "
                    f"and gradient card vs CPU: {err:.3e} (bound "
                    f"{GRAD_F64})")
            worst = max(worst, err)
    return worst


def fno_w_grads(precision, dtype, n=64, width=32, modes=21):
    """The fno_w objective's gradient on the card at `precision` in
    `dtype`, from one parameter draw and 9 frames of random vorticity."""
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    cfg = TrainConfig(model="fno_w", fno_width=width, fno_modes=modes,
                      fno_precision=precision)
    gen = torch.Generator().manual_seed(2)
    model = build_model(cfg, n, n, dtype=torch.float64, generator=gen)
    obs = torch.randn(9, 1, 3, n, n, generator=gen, dtype=torch.float64)
    model = model.to(DEVICE, dtype)
    return loss_and_grads(cfg, model, obs.to(DEVICE, dtype))[1]


def tf32_gradient_check() -> dict:
    """The float32 gradient at precision None against float64 on the card:
    as the library leaves TF32, and with TF32 turned on by the caller (the
    backward products run after the forward's switch has returned, so they
    need their own: ops/gemm.py::_Product). Two controls with the caller's
    TF32 on must fail the bound: the plain matmul, whose backward autograd
    runs outside the forward's switch, and the switch taken out as well."""
    from ns_tpu_torch.ops import gemm

    want = fno_w_grads(None, torch.float64)
    out = {"f32": grad_error(fno_w_grads(None, torch.float32), want)}
    prev, rule, apply = (torch.backends.cuda.matmul.allow_tf32,
                         gemm._no_tf32, gemm._apply)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        out["f32_caller_tf32"] = grad_error(
            fno_w_grads(None, torch.float32), want)
        gemm._apply = lambda product, a, b: product(a, b)
        out["control_tf32_backward"] = grad_error(
            fno_w_grads(None, torch.float32), want)
        gemm._no_tf32 = contextlib.nullcontext
        out["control_tf32"] = grad_error(
            fno_w_grads(None, torch.float32), want)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, gemm._no_tf32,
         gemm._apply) = prev, rule, apply
    require(out["f32"] <= GRAD_F32 and out["f32_caller_tf32"] <= GRAD_F32,
            f"float32 gradient vs float64: {out} (bound {GRAD_F32})")
    require(min(out["control_tf32_backward"], out["control_tf32"])
            > GRAD_F32, f"a TF32 control passed the bound: {out}")
    return out


def default_gradient_check() -> dict:
    """A 'default' fno_w step's gradient (bf16 operands and cotangents,
    fp32 sums, forward and backward) against a float64 emulation of the
    same GEMMs (operands rounded to bf16, products in float64); a control
    whose backward rounds nothing (fp32 products, the forward unchanged)
    must fail the bound; the distance to the unrounded float64 gradient
    beside them."""
    from ns_tpu_torch.models import fno
    from ns_tpu_torch.ops import gemm

    def bf16_f64(a, b):
        r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
        return r(a) @ r(b)

    plain, product = gemm.matmul, gemm._Product

    def emulated(a, b, precision):
        if precision == "default" and a.dtype == torch.float64 \
                and not (a.is_complex() or b.is_complex()):
            return gemm._apply(bf16_f64, a, b)
        return plain(a, b, precision)

    class Fp32Backward(product):
        @staticmethod
        def forward(ctx, a, b, forward_product):
            ctx.save_for_backward(a, b)
            ctx.product = gemm._fp32_product
            return forward_product(a, b)

    got = fno_w_grads("default", torch.float32)
    exact = fno_w_grads("default", torch.float64)
    gemm.matmul = fno.matmul = emulated
    try:
        want = fno_w_grads("default", torch.float64)
    finally:
        gemm.matmul = fno.matmul = plain
    gemm._Product = Fp32Backward
    try:
        control = fno_w_grads("default", torch.float32)
    finally:
        gemm._Product = product
    out = {"vs_emulation": grad_error_l2(got, want),
           "control_fp32_backward": grad_error_l2(control, want),
           "vs_float64": grad_error_l2(got, exact),
           "vs_emulation_max": grad_error(got, want)}
    require(all(math.isfinite(float(g.abs().max())) for g in got.values()),
            "'default' gradient not finite")
    require(out["vs_emulation"] <= GRAD_DEFAULT
            < out["control_fp32_backward"],
            f"'default' gradient vs its emulation: {out} (bound "
            f"{GRAD_DEFAULT}, which the control must exceed)")
    return out


def ensemble_check(tmp, npz: str) -> dict:
    """EnsembleTrainer, two fno_w members on TRAIN's grid (width 16, 20
    frames), 4 iterations on the card: finite losses (4, 2), counts
    [4, 4]."""
    from ns_tpu_torch.train.ensemble import EnsembleTrainer

    cfg = dataclasses.replace(
        fno_w_config(npz, os.path.join(tmp, "ensemble")), fno_width=16,
        fno_modes=12, n_frames=min(20, TRAIN["frames"]), n_iters=4,
        ckpt_every=2)
    with contextlib.redirect_stdout(io.StringIO()):
        tr = EnsembleTrainer(cfg, 2, device=DEVICE)
        losses = np.asarray(tr.train())
    extrap = tr.extrapolate()
    with np.load(os.path.join(cfg.out_dir, "checkpoint.npz")) as d:
        counts = d["opt_state/0/.count"].tolist()
    require(losses.shape == (4, 2) and np.isfinite(losses).all()
            and counts == [4, 4], f"ensemble: losses {losses}, counts "
            f"{counts}")
    n = TRAIN["n"]
    require(extrap.shape == (2, TRAIN["frames"], 3, n, n)
            and np.isfinite(extrap).all(), f"ensemble extrapolation "
            f"{extrap.shape}")
    return {"losses": losses.tolist()}


def phase_train(tmp, card: str) -> dict:
    """The reference pipeline and the full-width fno_w training on the
    card, then the gradient, precision, resume and ensemble checks."""
    print("phase 4/5: training (cli.train, Trainer, EnsembleTrainer)")
    t0 = time.perf_counter()
    npz = training_data(tmp)
    out = {"data_s": time.perf_counter() - t0, "device": card}
    out["basis_ode"] = reference_pipeline(tmp)
    out["fno_w"] = fw = train_full_width(tmp, npz)
    require(fw["resume_losses_equal"] and fw["resume_params_max_abs"] == 0,
            f"resume on the card: losses equal {fw['resume_losses_equal']}, "
            f"params differ by {fw['resume_params_max_abs']}")
    out["families_grad_f64"] = families_grad_f64()
    out["tf32"] = tf32_gradient_check()
    out["default"] = default_gradient_check()
    out["ensemble"] = ensemble_check(tmp, npz)
    b, pr = out["basis_ode"], fw["profile"]
    print(f"  data: {TRAIN['frames']} frames of 128^2 turbulence in "
          f"{out['data_s']:.1f} s; basis_ode 51^2 K=10: "
          f"{b['s_per_iter']:.3f} s/iteration, loss {b['losses'][0]:.1f} "
          f"-> {b['losses'][-1]:.1f} in {TRAIN['basis_iters']}, K1 "
          f"launches {b['k1_launches']}, rel-L2 {b['rel_l2']}; {card}")
    print(f"  fno_w 128^2 w64 m43 full batch: "
          f"{pr['steps_per_s_median_of_3']:.2f} it/s, idle "
          f"{pr['device_idle_share']:.3f}, "
          f"{pr['device_records_per_step']:.0f} device records an "
          f"iteration, peak {fw['peak_gb']:.2f} GB, loss "
          f"{fw['losses'][0]:.2f} -> {fw['losses'][-1]:.2f}; top "
          f"{pr['top_device_ms'][:3]}; {card}")
    print(f"  checks: resume bitwise; families f64 "
          f"{out['families_grad_f64']:.2e}; f32 gradient {out['tf32']}; "
          f"'default' {out['default']}; ensemble ok")
    return out


# --- the 3D surrogates (phases 4 and 5) --------------------------------------
# Neither package's 3D surrogate path reaches a Pallas kernel: the JAX
# models are plain XLA and the data step (64^3 at 'high') takes the plain
# matmul route. The phase trains the JAX package's 3D flagship on the card,
# serves its checkpoint, and holds the families, the engines and
# cli.evaluate to the CPU.

# fno3d_a at 64^3, width 24, modes 16, depth 4, float32 at precision None,
# 'auto' -> matmul, dealias on; 4-step pushforward with remat, batch 4,
# lr 1e-3 cosine with 100 warm-up iterations over a 1500-iteration
# horizon, clip 1.0 (RESULTS.md "3D surrogate extrapolation quality",
# round-5 row "width 24, modes 16, 1500 iters, cosine+warmup+clip"); data:
# decaying turbulence (dt 1e-3, nu 6.25e-4, k_peak max(3, n/16), seed 0,
# 100 steps a frame; tools/bench_surrogates3d.py:105-125). Cut: 40 frames
# (not 200) and 20 iterations (not 1500, the schedule's horizon kept).
SURR3D = dict(n=64, width=24, modes=16, frames=40, stride=100, iters=20,
              chunk=10, steps=100, batch=4, serve_chunk=16, repeats=3,
              family_n=12, eval_frames=6)
SURR3D_CARD_VS_CPU = 1e-4   # float32, 4 steps at B=1, of max|u|
SURR3D_BUDGET_S = 90


def turbulence3d_data(tmp) -> tuple:
    """SURR3D's decaying-turbulence rollout of the port's 3D solver as an
    npz of (u, v, w, p) (frames, n, n, n); returns (path, seconds)."""
    from ns_tpu_torch.solvers import spectral3d as s3

    n = SURR3D["n"]
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, dt=1e-3, nu=6.25e-4,
                              dtype="float32", transform="auto")
    u0 = s3.random_solenoidal_velocity(cfg, seed=0, k_peak=max(3.0, n / 16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = s3.simulate_strided(cfg, u0, SURR3D["frames"],
                                 stride=SURR3D["stride"], device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = os.path.join(tmp, "turbulence3d_64.npz")
    np.savez(path, **{k: f.cpu().numpy() for k, f in zip("uvwp", fields)})
    return path, seconds


def fno3d_a_config(npz: str, out_dir: str, **kw):
    from ns_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(model="fno3d_a", npz_path=npz, out_dir=out_dir,
                       fno_width=SURR3D["width"], fno_modes=SURR3D["modes"],
                       n_frames=SURR3D["frames"], n_iters=SURR3D["iters"],
                       ckpt_every=SURR3D["chunk"], fno_rollout_steps=4,
                       fno_remat=True, batch_size=4, lr=1e-3,
                       lr_schedule="cosine", warmup_iters=100,
                       schedule_horizon=1500, grad_clip=1.0, **kw)


def train3d_full_width(tmp, npz: str) -> dict:
    """fno3d_a at SURR3D's configuration: 20 iterations in chunks of 10
    (finite losses, peak memory), one chunk under set_sync_debug_mode
    ("error"), one profiled chunk (it/s, idle share, device records an
    iteration), then 10 + a resume of 10 against the 20 bitwise."""
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.train.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    cfg = fno3d_a_config(npz, os.path.join(tmp, "fno3d_a"))
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=DEVICE)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        losses = tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(len(losses) == SURR3D["iters"] and all(map(math.isfinite,
                                                       losses)),
            f"fno3d_a losses {losses}")
    params = {k: v.detach().clone() for k, v in tr.params.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_chunk(SURR3D["chunk"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prof = profile_run.profile_rollout(
        lambda: tr.train_chunk(SURR3D["chunk"]), SURR3D["chunk"])
    del tr
    half = fno3d_a_config(npz, os.path.join(tmp, "fno3d_a_half"))
    with contextlib.redirect_stdout(io.StringIO()):
        Trainer(dataclasses.replace(half, n_iters=SURR3D["chunk"]),
                device=DEVICE).train()
        tr = Trainer(dataclasses.replace(
            half, resume=os.path.join(half.out_dir, "checkpoint.npz")),
            device=DEVICE)
        resumed = tr.train()
    worst = max(float((tr.params[k].detach() - params[k]).abs().max())
                for k in params)
    del tr, params
    require(resumed == losses and worst == 0,
            f"fno3d_a resume on the card: losses equal {resumed == losses}, "
            f"params differ by {worst}")
    return {"setup_s": setup, "train_20_s": train_s, "losses": losses,
            "peak_gb": peak / 1e9, "ckpt": os.path.join(cfg.out_dir,
                                                        "checkpoint.npz"),
            "profile": {k: prof[k] for k in (
                "steps_per_s_median_of_3", "steps_per_s", "device_idle_share",
                "device_records_per_step", "device_busy_ms",
                "profiled_wall_ms", "top_device_ms", "top_host_self_ms")}}


def spectral_divergence3d(reply: np.ndarray) -> float:
    """max|div (u, v, w)| / max|u| of a (..., 4, n, n, n) reply, the exact
    spectral definition in float64 on the card."""
    from ns_tpu_torch.solvers.spectral3d import _ik_mul, irfft3

    n = reply.shape[-1]
    u = torch.as_tensor(np.ascontiguousarray(reply[..., :3, :, :, :]),
                        device=DEVICE).to(torch.float64)
    uh = torch.fft.rfftn(u, dim=(-3, -2, -1))
    k = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64, device=DEVICE)
    kz = torch.fft.rfftfreq(n, 1.0 / n, dtype=torch.float64, device=DEVICE)
    div = irfft3(_ik_mul(k[:, None, None], uh[..., 0, :, :, :])
                 + _ik_mul(k[None, :, None], uh[..., 1, :, :, :])
                 + _ik_mul(kz, uh[..., 2, :, :, :]), (n, n, n))
    return float(div.abs().max() / u.abs().max())


def families3d_f64() -> float:
    """fno3d (with fno_project), fno3d_w and fno3d_a in float64 at 12^3,
    both engines, card against CPU from the same parameters and inputs: a
    3-step rollout with its filter and recovery, and the 2-step objective
    with its gradient. Returns the worst error of max."""
    from ns_tpu_torch.train.trainer import (TrainConfig, build_model,
                                            rollout_post, state_of_fields,
                                            uvp_of_state)

    n, worst = SURR3D["family_n"], 0.0
    gen = torch.Generator().manual_seed(0)
    obs = torch.randn(6, 1, 4, n, n, n, generator=gen, dtype=torch.float64)
    for model in ("fno3d", "fno3d_w", "fno3d_a"):
        for transform in ("fft", "matmul"):
            cfg = TrainConfig(model=model, fno_width=6, fno_modes=4,
                              fno_transform=transform, fno_project=True,
                              fno_rollout_steps=2)
            cpu = build_model(cfg, n, n, n, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(1))
            with torch.no_grad():  # spectral weights at scale 1
                for name, p in cpu.named_parameters():
                    if name.startswith("spectral."):
                        p.mul_(cfg.fno_width ** 2)
            card = build_model(cfg, n, n, n, dtype=torch.float64,
                               device="meta").to_empty(device=DEVICE)
            card.load_state_dict(cpu.state_dict())
            post = rollout_post(cfg)

            def run(m, x):
                s = state_of_fields(cfg, x)
                return uvp_of_state(cfg, m.rollout(s, 3, post=post))

            with torch.inference_mode():
                want = run(cpu, obs[0])
                got = run(card, obs[0].to(DEVICE)).cpu()
            err = float((got - want).abs().max() / want.abs().max())
            lw, gw = loss_and_grads(cfg, cpu, obs)
            lg, gg = loss_and_grads(cfg, card, obs.to(DEVICE))
            err = max(err, abs(float(lg) - float(lw)) / abs(float(lw)),
                      grad_error(gg, gw))
            require(bool(torch.isfinite(got).all()) and err <= FAMILY_F64,
                    f"{model} {transform} f64 {n}^3 card vs CPU: {err:.3e} "
                    f"(bound {FAMILY_F64})")
            worst = max(worst, err)
    return worst


def fft_vs_matmul_card3d() -> dict:
    """The two 3D spectral engines on the card at the served shape (B = 4,
    width 24, 64^3, modes 16) with random complex weights (scale 1/width;
    the kz = 0 plane of the mixed spectrum is not Hermitian), float32, at
    the 2D phase's bounds (rtol 2e-4, atol 1e-5): the worst |diff| / (atol
    + rtol |want|), and the two engines' ms a layer, in turns."""
    from ns_tpu_torch.models.fno3d import (SpectralWeights3D,
                                           _spectral_conv3d_fft,
                                           _spectral_conv3d_matmul)

    gen = torch.Generator().manual_seed(0)
    n, c, m = SURR3D["n"], SURR3D["width"], SURR3D["modes"]
    mz = min(m, n // 2 + 1)
    s = SpectralWeights3D(c, c, 4 * m * m * mz, 1.0 / c, generator=gen)
    W = s.mixing_table(torch.float32).detach().to(DEVICE)
    x = torch.randn(SURR3D["batch"], c, n, n, n, generator=gen).to(DEVICE)
    with torch.no_grad():
        a = _spectral_conv3d_fft(W, x, m, m, mz)
        b = _spectral_conv3d_matmul(W, x, m, m, mz)
        r = float(((a - b).abs() / (1e-5 + 2e-4 * b.abs())).max())
        ms = turns_ms([lambda: _spectral_conv3d_fft(W, x, m, m, mz),
                       lambda: _spectral_conv3d_matmul(W, x, m, m, mz)], 10)
    require(r <= 1.0, f"3D fft vs matmul on the card: {r:.3f} of the bound "
            "rtol 2e-4 atol 1e-5")
    return {"of_bound": r, "fft_ms": ms[0], "matmul_ms": ms[1],
            "out_max": float(b.abs().max())}


def evaluate3d_card_vs_cpu(tmp, ckpt: str, npz: str) -> float:
    """`evaluate_on_both` on the first SURR3D["eval_frames"] frames of the
    64^3 data."""
    short = os.path.join(tmp, "turbulence3d_short.npz")
    with np.load(npz) as d:
        np.savez(short, **{k: d[k][:SURR3D["eval_frames"]] for k in "uvwp"})
        umax = float(np.abs(d["u"][:SURR3D["eval_frames"]]).max())
    return evaluate_on_both(tmp, ckpt, short, umax, "cli.evaluate 3D")


def divergence_max_card_vs_cpu() -> dict:
    """spectral3d.divergence_max of a float64 field that is not
    band-limited (its i*k Nyquist rows make a non-Hermitian spectrum), on
    the card against the CPU, through the fft engine's inverse."""
    from ns_tpu_torch.solvers import spectral3d as s3

    n = SURR3D["n"]
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, dtype="float64")
    u = torch.randn(3, n, n, n, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    uh = torch.fft.rfftn(u, dim=(-3, -2, -1))
    want = float(s3.divergence_max(cfg, uh))
    got = float(s3.divergence_max(cfg, uh.to(DEVICE)))
    rel = abs(got - want) / want
    require(rel <= 1e-12, f"divergence_max card {got!r} vs CPU {want!r}")
    return {"card": got, "cpu": want, "rel": rel}


def phase_surrogate3d(tmp, card: str) -> dict:
    """Train fno3d_a at SURR3D's configuration on the card, serve its
    checkpoint through InferenceEngine.from_checkpoint (B = 1 and B = 4,
    100-step requests, chunk 16, a profiled chunk each), and hold it:
    finite, solenoidal, card against CPU, the families in float64, fft
    against matmul, cli.evaluate card against CPU, divergence_max card
    against CPU; no kernel of the library launched."""
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.serve import InferenceEngine

    print("phase 4/5: the 3D surrogates (no kernel of the library)")
    before = kernels.launch_counts()
    n, steps, b = SURR3D["n"], SURR3D["steps"], SURR3D["batch"]
    npz, data_s = turbulence3d_data(tmp)
    out = {"config": {"model": "fno3d_a", "grid": [n, n, n],
                      "width": SURR3D["width"], "modes": SURR3D["modes"],
                      "depth": 4, "frames": SURR3D["frames"],
                      "iters": SURR3D["iters"], "batch_size": 4,
                      "rollout_steps": 4, "remat": True,
                      "steps": steps, "serve_chunk": SURR3D["serve_chunk"]},
           "data_s": data_s, "device": card}
    out["train"] = tr = train3d_full_width(tmp, npz)
    ckpt = tr.pop("ckpt")
    engine = InferenceEngine.from_checkpoint(
        ckpt, chunk=SURR3D["serve_chunk"], device=DEVICE)
    out["config"]["transform"] = engine.models[0].transform
    with np.load(npz) as d:
        x4 = np.stack([d[k][:b] for k in "uvwp"], axis=1)  # (B, 4, n, n, n)
    serve = {}
    for label, x, bb in (("b1", x4[0], 1), ("b4", x4, b)):
        engine.warmup(SURR3D["serve_chunk"], batch=bb)
        serve[label] = serve_rate(engine, x, steps, SURR3D["repeats"], bb)
        r = profile_run.profile_rollout(
            lambda x=x: engine.predict(x, SURR3D["serve_chunk"]),
            SURR3D["serve_chunk"])
        serve["profile_" + label] = {k: r[k] for k in (
            "steps_per_s_median_of_3", "device_idle_share",
            "device_records_per_step", "device_busy_ms", "profiled_wall_ms",
            "top_device_ms", "top_host_self_ms", "memcpy_dtoh_ms")}
        # the reply's copy: the profiled chunk's device-to-host records
        require(r["memcpy_dtoh_ms"] > 0,
                f"the profiled {label} chunk recorded no reply copy")
        serve[label].update(
            copy_ms_per_frame=r["memcpy_dtoh_ms"] / (SURR3D["serve_chunk"]
                                                     * bb),
            frame_ms=r["profiled_wall_ms"] / (SURR3D["serve_chunk"] * bb),
            copy_share=r["memcpy_dtoh_ms"] / r["profiled_wall_ms"])
    out["serve"] = serve
    reply = engine.predict(x4, steps)
    require(reply.shape == (b, steps + 1, 4, n, n, n)
            and bool(np.isfinite(reply).all()),
            f"fno3d_a reply {reply.shape}, finite {np.isfinite(reply).all()}")
    out["divergence_rel"] = spectral_divergence3d(reply)
    out["divergence_rel_request"] = spectral_divergence3d(x4)
    del reply
    require(out["divergence_rel"] <= SURR_DIV,
            f"fno3d_a reply divergence {out['divergence_rel']:.3e} of "
            f"max|u| (bound {SURR_DIV})")
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    want = cpu.predict(x4[0], 4)
    got = engine.predict(x4[0], 4)
    out["card_vs_cpu_f32"] = float(np.abs(got - want).max()
                                   / np.abs(want[:, :3]).max())
    require(out["card_vs_cpu_f32"] <= SURR3D_CARD_VS_CPU,
            f"fno3d_a f32 card vs CPU {out['card_vs_cpu_f32']:.3e} of max|u| "
            f"(bound {SURR3D_CARD_VS_CPU})")
    del cpu, engine
    out["families_f64"] = families3d_f64()
    out["fft_vs_matmul"] = fft_vs_matmul_card3d()
    out["evaluate_rel"] = evaluate3d_card_vs_cpu(tmp, ckpt, npz)
    out["divergence_max_card_vs_cpu"] = divergence_max_card_vs_cpu()
    ran = {k for k, c in kernels.launch_counts().items() if c > before[k]}
    require(not ran, f"the 3D surrogate phase launched kernels: {ran}")
    pr, t = tr["profile"], tr
    print(f"  data: {SURR3D['frames']} frames of {n}^3 turbulence "
          f"({SURR3D['frames'] * SURR3D['stride']} solver steps) in "
          f"{data_s:.1f} s; {card}")
    print(f"  fno3d_a {n}^3 w{SURR3D['width']} m{SURR3D['modes']} k=4 remat "
          f"B=4: {pr['steps_per_s_median_of_3']:.2f} it/s, idle "
          f"{pr['device_idle_share']:.3f}, "
          f"{pr['device_records_per_step']:.0f} device records an "
          f"iteration, peak {t['peak_gb']:.2f} GB, loss {t['losses'][0]:.3f}"
          f" -> {t['losses'][-1]:.3f}; top {pr['top_device_ms'][:3]}; {card}")
    for label in ("b1", "b4"):
        r, p = serve[label], serve["profile_" + label]
        print(f"  served {label.upper()}: {r['frames_per_s']:.1f} frames/s, "
              f"p50 {r['p50_s'] * 1e3:.1f} ms a {steps}-step request; "
              f"reply copy {r['copy_ms_per_frame']:.2f} of "
              f"{r['frame_ms']:.2f} ms a frame ({r['copy_share']:.2f}); "
              f"chunk {p['steps_per_s_median_of_3']:.1f} steps/s, idle "
              f"{p['device_idle_share']:.3f}; top {p['top_device_ms'][:3]}")
    fm = out["fft_vs_matmul"]
    print(f"  checks: resume bitwise; divergence {out['divergence_rel']:.2e} "
          f"of max|u| (request {out['divergence_rel_request']:.2e}); card vs "
          f"CPU f32 {out['card_vs_cpu_f32']:.2e}; families f64 "
          f"{out['families_f64']:.2e}; fft vs matmul {fm['of_bound']:.3f} "
          f"of the bound (fft {fm['fft_ms']:.3f}, matmul "
          f"{fm['matmul_ms']:.3f} ms a layer); cli.evaluate "
          f"{out['evaluate_rel']:.2e}; divergence_max card vs CPU "
          f"{out['divergence_max_card_vs_cpu']['rel']:.1e}")
    return out


# --- serving and runtime (phases 4 and 5) -------------------------------------
# The HTTP service (serve/server.py with coalescing, the client, cli.serve),
# the solver oracles, the runtime engines replayed from CUDA graphs against
# their eager loops (the kernels K1-K4, K6 and K8 run from the graphs) and
# --stream-dir with the native writer.

SERVE = dict(clients=8, steps=200, bursts=3, oracle_frames=10,
             oracle_n=128, oracle_stride=100, oracle3d_n=64,
             oracle3d_stride=10, stream_nt=100)
SERVE_BUDGET_S = 75
ORACLE_VS_PLAIN = 1e-4   # float32 oracle frames vs a plain loop, of max|u|
# (label, engine, configuration, nt): every runtime configuration the phase
# replays, at the main path's shapes
RUNTIME_RUNS = [
    ("bench 2d 1024^2", "periodic", dict(nx=N2D, dt=5e-4, nu=1e-4), 300),
    ("chorin_fd explicit 51^2", "chorin_fd", dict(nx=51), 200),
    ("chorin_fd explicit 1024^2", "chorin_fd",
     dict(nx=1024, dt=1e-5, nu=0.01), 50),
    ("direct_fd 50^2", "direct_fd", dict(nx=50), 200),
    ("direct_fd 1024^2", "direct_fd", dict(nx=1024, dt=1e-5, nu=0.01), 20),
    ("taylor_green_3d 256^3 fused", "3d", dict(nx=N3D), 8),
]
# the kernel symbol each wrapper's launches show in the profiler's records
# (K8: the first of its two kernels)
KERNEL_SYMBOLS = {"sor_redblack_fused": "sor_redblack_fused_kernel",
                  "jacobi_fused": "jacobi_fused_kernel",
                  "jacobi_multiblock": "jacobi_tiled_kernel",
                  "momentum_explicit_fused": "momentum_kernel",
                  "sor_redblack_packed_multiblock":
                      "sor_packed_resident_kernel",
                  "fused_zy_forward": "zy_forward_bf16_kernel",
                  "fused_lamb": "lamb_phys_bf16_kernel"}


class _Server:
    """serve/server.py's make_server on port 0, served from a daemon
    thread; close() shuts it down (the dispatcher's thread too)."""

    def __init__(self, engine, coalesce=0):
        import threading

        from ns_tpu_torch.serve.server import make_server
        self.httpd = make_server(engine, port=0, coalesce=coalesce)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def kernel_launches(records) -> dict:
    """Launches of each wrapper's kernel among profiler device records."""
    return {name: sum(1 for r in records
                      if f"::{sym}<" in r or f"::{sym}(" in r)
            for name, sym in KERNEL_SYMBOLS.items()}


def profiled_records(fn) -> list:
    """The names of the device records of one call of fn
    (runtime/engine.py's `_device_records`)."""
    from ns_tpu_torch.runtime.engine import _device_records

    return [name for name, _ in _device_records(fn, torch.device(DEVICE))]


def serve_http(tmp, card: str) -> dict:
    """fno_w (SURROGATE) behind make_server(coalesce=8): SERVE["clients"]
    concurrent ServeClients with 200-step requests, each reply held to the
    serialized engine.predict reply; a client-batched request on the lock
    path; the single-model reduce contract; cli.serve as a subprocess
    (started first: it loads the checkpoint while this process loads its
    engine, and it is stopped before the timed requests)."""
    from concurrent.futures import ThreadPoolExecutor

    from ns_tpu_torch.serve import InferenceEngine, ServeClient

    n, steps, k = SURROGATE["n"], SERVE["steps"], SERVE["clients"]
    folder = os.path.join(tmp, "fno_w_128")  # the surrogate phase's
    ckpt = os.path.join(folder, "checkpoint.npz")
    if not os.path.isfile(ckpt):
        ckpt, _ = fno_w_checkpoint(folder)
    # python -m ns_tpu_torch.cli.serve, as a user starts it
    t_cli = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ns_tpu_torch.cli.serve", "--ckpt", folder,
         "--port", "0", "--warmup-steps", "8", "--device", DEVICE,
         "--quiet"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": ROOT}, cwd=ROOT)
    out = {"clients": k, "steps": steps, "device": card}
    try:
        engine = InferenceEngine.from_checkpoint(
            ckpt, chunk=SURROGATE["chunk"], device=DEVICE)
        xs = turbulence_frames(range(100, 100 + k), DEVICE)
        engine.warmup(SURROGATE["chunk"], batch=k)
        want = [engine.predict(x, steps) for x in xs]  # serialized replies
        umax = max(float(np.abs(w[:, :2]).max()) for w in want)
        line = ""
        for line in proc.stdout:
            if line.startswith("serving"):
                break
        require(line.startswith(f"serving fno_w ({n}x{n}) on http://"),
                f"cli.serve printed {line!r}")
        c = ServeClient("127.0.0.1", int(line.rsplit(":", 1)[1]),
                        timeout=120)
        require(c.health()["model"] == "fno_w", "cli.serve /health")
        r = c.rollout(xs[0], 8)
        require(r.shape == (9, 3, n, n) and bool(np.isfinite(r).all()),
                f"cli.serve reply {r.shape}")
        out["cli_serve_vs_engine"] = float(np.abs(r - want[0][:9]).max()
                                           / umax)
        require(out["cli_serve_vs_engine"] <= SURR_CARD_VS_CPU,
                f"cli.serve reply {out['cli_serve_vs_engine']:.3e}")
        out["cli_serve_s"] = time.perf_counter() - t_cli
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
    srv = _Server(engine, coalesce=8)
    try:
        clients = [ServeClient("127.0.0.1", srv.port) for _ in range(k)]

        def request(i):
            t0 = time.perf_counter()
            r = clients[i].rollout(xs[i], steps)
            return r, time.perf_counter() - t0

        lat, walls, worst = [], [], 0.0
        with ThreadPoolExecutor(max_workers=k) as ex:
            for _ in range(SERVE["bursts"]):
                t0 = time.perf_counter()
                got = list(ex.map(request, range(k)))
                walls.append(time.perf_counter() - t0)
                for (r, s), w in zip(got, want):
                    require(r.shape == w.shape,
                            f"coalesced reply {r.shape}, want {w.shape}")
                    worst = max(worst, float(np.abs(r - w).max()) / umax)
                    lat.append(s)
        st = srv.httpd.dispatcher.stats()
        require(worst <= SURR_CARD_VS_CPU,
                f"coalesced vs serialized {worst:.3e} of max|u| (bound "
                f"{SURR_CARD_VS_CPU})")
        require(st["batches"] < st["coalesced_requests"],
                f"no request was coalesced: {st}")
        lat.sort()
        wall = sorted(walls)[len(walls) // 2]
        out.update(coalesced_vs_serialized=worst, dispatcher=st,
                   mean_batch=st["coalesced_requests"] / st["batches"],
                   burst_wall_s=walls, requests_per_s=k / wall,
                   frames_per_s=k * steps / wall,
                   p50_s=lat[len(lat) // 2],
                   p99_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))])
        # a client-batched request keeps the serialized lock path
        c, short = clients[0], steps // 4
        r = c.rollout(xs, short)
        require(r.shape == (k, short + 1, 3, n, n),
                f"client-batched reply {r.shape}")
        out["batched_vs_serialized"] = max(
            float(np.abs(r[i] - want[i][:short + 1]).max()) / umax
            for i in range(k))
        require(out["batched_vs_serialized"] <= SURR_CARD_VS_CPU,
                f"batched vs serialized {out['batched_vs_serialized']:.3e}")
        m = c.rollout(xs[0], 8, reduce="members")
        sp_ = c.rollout(xs[0], 8, reduce="spread")
        require(m.shape == (1, 9, 3, n, n) and sp_.shape == (9, 3, n, n)
                and not sp_.any(), f"reduce: members {m.shape}, spread "
                f"{sp_.shape} (zero: {not sp_.any()})")
    finally:
        srv.close()
    require(not srv.httpd.dispatcher._thread.is_alive(),
            "the dispatcher outlived its server")
    print(f"  fno_w {n}^2 over HTTP, coalesce 8: {k} clients x {steps} "
          f"steps: {out['requests_per_s']:.2f} requests/s, "
          f"{out['frames_per_s']:.1f} frames/s, p50 {out['p50_s']:.3f} s, "
          f"p99 {out['p99_s']:.3f} s, mean batch {out['mean_batch']:.2f} "
          f"({st['batches']} batches); coalesced vs serialized "
          f"{worst:.2e} of max|u|; cli.serve up and answered in "
          f"{out['cli_serve_s']:.1f} s; {card}")
    return out


def serve_oracles(card: str) -> dict:
    """SolverEngine (fno_w's data physics, 100 steps a frame) and
    SolverEngine3D (fno3d_a's, 10 steps a frame) over HTTP: frames held to
    a plain step loop of the port's solver from the echoed state, spectral
    divergence of each reply, frames/s of a warm request."""
    from ns_tpu_torch.models.vorticity import vorticity_from_uv
    from ns_tpu_torch.serve import ServeClient, SolverEngine, SolverEngine3D
    from ns_tpu_torch.solvers import spectral3d as s3
    from ns_tpu_torch.solvers import spectral_periodic as sp

    nf = SERVE["oracle_frames"]
    n2, st2 = SERVE["oracle_n"], SERVE["oracle_stride"]
    n3, st3 = SERVE["oracle3d_n"], SERVE["oracle3d_stride"]
    c3 = s3.Spectral3DConfig(nx=n3, ny=n3, nz=n3)
    u3 = s3.random_solenoidal_velocity(c3, seed=0, k_peak=max(3.0, n3 / 16))
    x3 = np.concatenate([u3, np.zeros((1, n3, n3, n3))]).astype(np.float32)
    x2 = turbulence_frames([7], DEVICE, n2)[0]
    out = {"device": card}
    for label, eng, x, stride in (
            ("oracle_2d", SolverEngine(n2, n2, dt=1e-3, nu=1e-3, stride=st2,
                                       device=DEVICE), x2, st2),
            ("oracle_3d", SolverEngine3D(n3, n3, n3, dt=1e-3, nu=6.25e-4,
                                         stride=st3, device=DEVICE), x3,
             st3)):
        srv = _Server(eng)
        try:
            c = ServeClient("127.0.0.1", srv.port)
            c.rollout(x, 1)                                 # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reply = c.rollout(x, nf)
            seconds = time.perf_counter() - t0
        finally:
            srv.close()
        require(reply.shape == (nf + 1,) + x.shape
                and bool(np.isfinite(reply).all()),
                f"{label} reply {reply.shape}")
        echo = torch.as_tensor(reply[0], device=DEVICE)
        if label == "oracle_2d":
            cfg = eng.cfg
            w = vorticity_from_uv(echo[0], echo[1])
            plain = torch.stack(sp.simulate_strided(
                cfg, w, nf, stride=stride, spinup=stride - 1), 1)
            div = spectral_divergence(reply)
        else:
            cfg = eng.cfg
            plain = torch.stack(s3.simulate_strided(
                cfg, echo[:3], nf, stride=stride, spinup=stride - 1), 1)
            div = spectral_divergence3d(reply)
        plain = plain.cpu().numpy()
        umax = float(np.abs(reply[:, :-1]).max())
        err = float(np.abs(reply[1:] - plain).max()) / umax
        require(err <= ORACLE_VS_PLAIN,
                f"{label} vs a plain loop {err:.3e} of max|u| (bound "
                f"{ORACLE_VS_PLAIN})")
        require(div <= SURR_DIV, f"{label} divergence {div:.3e} of max|u| "
                f"(bound {SURR_DIV})")
        out[label] = {"grid": list(x.shape[1:]), "stride": stride,
                      "frames": nf, "latency_s": seconds,
                      "frames_per_s": nf / seconds,
                      "steps_per_s": nf * stride / seconds,
                      "vs_plain_loop": err, "divergence_rel": div,
                      "transform": cfg.transform,
                      "precision": cfg.matmul_precision}
        print(f"  {label} {'x'.join(map(str, x.shape[1:]))}, stride "
              f"{stride}: {nf / seconds:.2f} frames/s "
              f"({nf * stride / seconds:.1f} steps/s) over HTTP; vs plain "
              f"loop {err:.2e}, divergence {div:.2e} of max|u|; {card}")
    return out


def runtime_engine(kind: str, cfg_kw: dict, nt: int):
    """(engine, inputs) of one RUNTIME_RUNS configuration."""
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.runtime import (FDRolloutEngine, Rollout3DEngine,
                                      RolloutEngine)
    from ns_tpu_torch.solvers import chorin_fd, direct_fd
    from ns_tpu_torch.solvers import spectral3d as s3
    from ns_tpu_torch.solvers import spectral_periodic as sp

    if kind == "periodic":
        n = cfg_kw["nx"]
        cfg = sp.SpectralPeriodicConfig(
            nt=nt, nx=n, ny=n, dt=cfg_kw["dt"], nu=cfg_kw["nu"],
            transform="matmul", matmul_precision="default",
            compact_spectrum=True)
        w0 = sp.decaying_turbulence_vorticity(cfg, seed=0, k_peak=30.0)
        return RolloutEngine(cfg, device=DEVICE), (w0,)
    if kind == "3d":
        n = cfg_kw["nx"]
        cfg = s3.Spectral3DConfig(nt=nt, nx=n, ny=n, nz=n,
                                  transform="matmul",
                                  matmul_precision="default",
                                  use_pallas_transform="auto")
        require(cfg.use_pallas_transform is True, "3D auto gate resolved off")
        return (Rollout3DEngine(cfg, device=DEVICE),
                (s3.taylor_green_velocity(cfg),))
    n = cfg_kw["nx"]
    kw = dict(nt=nt, nx=n, ny=n, dt=cfg_kw.get("dt", 1e-3),
              nu=cfg_kw.get("nu", 0.1))
    cfg = (chorin_fd.ChorinFDConfig(nit=200, method="explicit", **kw)
           if kind == "chorin_fd" else direct_fd.DirectFDConfig(nit=50, **kw))
    z = np.zeros((n, n), np.float32)
    return (FDRolloutEngine(kind, cfg, *cavity_bcs(2.0 / (n - 1),
                                                   2.0 / (n - 1)),
                            device=DEVICE), (z, z, z))


def steps_per_s(fn, nt: int) -> float:
    """nt / seconds of one call of fn, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return nt / (time.perf_counter() - t0)


def runtime_replays(card: str) -> dict:
    """Each RUNTIME_RUNS configuration captured (captured=True), its replay
    bitwise equal to the eager loop, its kernels named in the device
    records of one replayed call, eager and replayed steps/s (median of
    3, in turns)."""
    out, replayed = {"device": card}, {k: 0 for k in KERNEL_SYMBOLS}
    for label, kind, cfg_kw, nt in RUNTIME_RUNS:
        t0 = time.perf_counter()
        eng, inputs = runtime_engine(kind, cfg_kw, nt)
        build_s = time.perf_counter() - t0
        require(eng.captured, f"{label}: not captured ({eng.eager_reason})")
        inputs = eng._inputs(*inputs)
        as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa
        a, b = as_tuple(eng(*inputs)), as_tuple(eng.eager(*inputs))
        require(all(bool(torch.isfinite(x).all()) for x in a),
                f"{label}: replay not finite")
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{label}: the replay differs from the eager loop")
        launches = kernel_launches(profiled_records(lambda: eng(*inputs)))
        for k, v in launches.items():
            replayed[k] += v
        eager, replay = [], []
        for mode in ("eager", "replay", "replay", "eager", "eager", "replay"):
            if mode == "eager":
                eager.append(steps_per_s(lambda: eng.eager(*inputs), nt))
            else:
                replay.append(steps_per_s(lambda: eng(*inputs), nt))
        med = lambda r: sorted(r)[len(r) // 2]  # noqa: E731
        out[label] = {"nt": nt, "captured": eng.captured,
                      "graphs": eng.stats()["graphs"], "chunk": eng.stats()[
                          "chunk"], "build_s": build_s,
                      "eager_steps_per_s": med(eager),
                      "replayed_steps_per_s": med(replay),
                      "eager_runs": eager, "replay_runs": replay,
                      "kernel_launches_replayed": {
                          k: v for k, v in launches.items() if v}}
        print(f"  {label}: captured, replay == eager bitwise; eager "
              f"{med(eager):.1f}, replayed {med(replay):.1f} steps/s "
              f"(median of 3 in turns); kernels in one replayed call "
              f"{out[label]['kernel_launches_replayed']}; {card}")
    out["launches_replayed"] = replayed
    return out


STREAM_RUNS = [
    ("chorin_fd explicit 1024^2", ["chorin_fd", "--method", "explicit",
                                   "--nx", "1024", "--dt", "1e-5", "--nu",
                                   "0.01"], "uvp"),
    ("decaying_turbulence 1024^2 bench engine",
     ["decaying_turbulence", "--nx", str(N2D), "--dt", "5e-4", "--nu",
      "1e-4", "--transform", "matmul", "--compact", "--precision",
      "default"], "uvp"),
]


def stream_runs(tmp, card: str) -> dict:
    """run_solver --stream-dir against the same command's npz run: each
    .npy bitwise equal to the npz field, the native writer in use, less
    device memory than the in-memory run; the FD run's K4 and K3 counted."""
    from ns_tpu_torch.io import native_writer
    from ns_tpu_torch.ops import kernels

    nt = SERVE["stream_nt"]
    backends = []
    init = native_writer.AsyncNpyWriter.__init__

    def spy(self, *a, **k):  # which backend each writer of the run took
        init(self, *a, **k)
        backends.append(self.backend)

    out = {"device": card, "nt": nt}
    for label, argv, names in STREAM_RUNS:
        argv = argv + ["--nt", str(nt)]
        res = {}
        for mode in ("npz", "stream"):
            extra = (["--out", os.path.join(tmp, f"{argv[0]}.npz")]
                     if mode == "npz" else
                     ["--stream-dir", os.path.join(tmp, f"{argv[0]}_s")])
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            native_writer.AsyncNpyWriter.__init__ = spy
            try:
                summary, _ = run_cli(argv + extra)
            finally:
                native_writer.AsyncNpyWriter.__init__ = init
            res[mode] = {"steps_per_s": summary["steps_per_s"],
                         "seconds": summary["seconds"],
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "launches": {k: v for k, v in
                                      kernels.launch_counts().items() if v}}
        with np.load(os.path.join(tmp, f"{argv[0]}.npz")) as d:
            for key in names:
                s = np.load(os.path.join(tmp, f"{argv[0]}_s", f"{key}.npy"))
                require(np.array_equal(s, d[key]),
                        f"{label}: streamed {key} differs from the npz")
        require(res["stream"]["peak_bytes"] < res["npz"]["peak_bytes"],
                f"{label}: streamed peak {res['stream']['peak_bytes']} >= "
                f"in-memory {res['npz']['peak_bytes']}")
        if argv[0] == "chorin_fd":
            for k in ("sor_redblack_packed_multiblock",
                      "momentum_explicit_fused"):
                require(res["stream"]["launches"].get(k, 0) > 0,
                        f"{label}: {k} did not launch in the streamed run")
        out[label] = res
        print(f"  {label} nt={nt}: streamed {res['stream']['steps_per_s']:.1f}"
              f" steps/s (peak {res['stream']['peak_bytes'] / 1e9:.2f} GB), "
              f"npz {res['npz']['steps_per_s']:.1f} steps/s (peak "
              f"{res['npz']['peak_bytes'] / 1e9:.2f} GB); files equal "
              f"bitwise; {card}")
    require(backends and set(backends) == {"native"},
            f"the stream runs' writers took {set(backends)}")
    out["writer_backends"] = sorted(set(backends))
    return out


def phase_serve_runtime(tmp, card: str) -> dict:
    """The HTTP service, the solver oracles, the runtime engines replayed
    from CUDA graphs and --stream-dir (module docstring)."""
    print("phase 4/5: serving (HTTP, coalescing, oracles), the runtime "
          "engines as CUDA graphs, --stream-dir")
    out, seconds = {}, {}

    for key, fn in (
            ("http", lambda: serve_http(tmp, card)),
            ("oracles", lambda: serve_oracles(card)),
            ("runtime", lambda: runtime_replays(card)),
            ("stream", lambda: stream_runs(tmp, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
    out["seconds"] = seconds
    print(f"  part seconds: {seconds}")
    return out


# --- phase 4/5: export ------------------------------------------------------
#
# The port's export (runtime/engine.py's export_* and load_*_artifact) of
# the main runs' configurations on the card: the hand-written kernels are
# operators of torch.ops.ns_tpu inside the exported programs, and the cg
# and gauss_seidel loops are while_loops there. Each artifact is run from
# the inputs of its eager engine and held to it.

EXPORT_BUDGET_S = 60
EXPORT_VS_ENGINE = 1e-6  # an exported program vs the engine, of max
_LARGE = dict(dt=1e-5, nu=0.01)
# (label, kind, configuration, nt, the kernels its rollout launches): the
# main runs' configurations (PERF.md section 4) and the two gated pressure
# modes at the reference size (the config's default nit, 50); the
# wavefront SOR, ~1 s a step of ~5,000 small launches a sweep, is cut to
# 4 steps
EXPORT_RUNS = [
    ("chorin_fd explicit 51^2", "chorin_fd",
     dict(nx=51, method="explicit", nit=200), 200,
     {"sor_redblack_fused", "momentum_explicit_fused"}),
    ("chorin_fd explicit 1024^2", "chorin_fd",
     dict(nx=1024, method="explicit", nit=200, **_LARGE), 50,
     {"sor_redblack_packed_multiblock", "momentum_explicit_fused"}),
    ("chorin_fd explicit 1025^2", "chorin_fd",
     dict(nx=1025, method="explicit", nit=200, **_LARGE), 10,
     {"sor_redblack_multiblock", "momentum_explicit_fused"}),
    ("direct_fd jacobi 50^2", "direct_fd", dict(nx=50, nit=50), 200,
     {"jacobi_fused"}),
    ("direct_fd jacobi 1024^2", "direct_fd", dict(nx=1024, nit=50, **_LARGE),
     20, {"jacobi_multiblock"}),
    ("chorin_fd semi_implicit cg 51^2", "chorin_fd",
     dict(nx=51, method="semi_implicit", pressure_mode="cg"), 20, set()),
    ("chorin_fd semi_implicit gauss_seidel 51^2", "chorin_fd",
     dict(nx=51, method="semi_implicit", pressure_mode="gauss_seidel"), 4,
     set()),
    ("chorin_fd semi_implicit dst 1024^2", "chorin_fd",
     dict(nx=1024, method="semi_implicit", pressure_mode="dst", **_LARGE),
     10, set()),
    ("taylor_green_3d 256^3 fused", "3d", dict(nx=N3D), 8,
     {"fused_zy_forward", "fused_lamb"}),
    ("taylor_green 256^2", "2d", dict(nx=256), 20, set()),
]


def export_case(kind: str, cfg_kw: dict, nt: int, path: str):
    """(engine, inputs, export) of one EXPORT_RUNS configuration; export()
    writes its artifact to path and returns its loaded rollout."""
    from ns_tpu_torch import runtime
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.solvers import chorin_fd, direct_fd
    from ns_tpu_torch.solvers import spectral3d as s3
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = cfg_kw.pop("nx")
    if kind == "3d":
        cfg = s3.Spectral3DConfig(nt=nt, nx=n, ny=n, nz=n,
                                  transform="matmul",
                                  matmul_precision="default",
                                  use_pallas_transform="auto")
        require(cfg.use_pallas_transform is True, "3D auto gate resolved off")
        return (runtime.Rollout3DEngine(cfg, device=DEVICE),
                (s3.taylor_green_velocity(cfg),),
                lambda: runtime.load_rollout3d_artifact(
                    runtime.export_rollout3d(cfg, path, DEVICE)))
    if kind == "2d":
        cfg = sp.SpectralPeriodicConfig(nt=nt, nx=n, ny=n)
        return (runtime.RolloutEngine(cfg, device=DEVICE),
                (sp.taylor_green_vorticity(cfg),),
                lambda: runtime.load_rollout_artifact(
                    runtime.export_rollout(cfg, path, DEVICE)))
    cfg = (chorin_fd.ChorinFDConfig if kind == "chorin_fd"
           else direct_fd.DirectFDConfig)(nt=nt, nx=n, ny=n, **{
               "dt": 1e-3, "nu": 0.1, **cfg_kw})
    bcs = cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))
    z = np.zeros((n, n), np.float32)
    return (runtime.FDRolloutEngine(kind, cfg, *bcs, device=DEVICE),
            (z, z, z),
            lambda: runtime.load_fd_rollout_artifact(
                runtime.export_fd_rollout(kind, cfg, *bcs, path,
                                          device=DEVICE)))


def counted_run(fn, nt: int) -> tuple:
    """(outputs, kernel launches, steps/s) of one call of fn, the counts
    set to 0 just before it and read just after."""
    from ns_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rate = nt / (time.perf_counter() - t0)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    return (out if isinstance(out, tuple) else (out,)), launches, rate


def phase_export(tmp, card: str) -> dict:
    """Each EXPORT_RUNS configuration exported on the card, loaded and run
    from its eager engine's inputs: its fields bitwise the engine's eager
    loop (else within EXPORT_VS_ENGINE of max, and the line says so), its
    kernels launched by the artifact's run as often as by the eager run
    (the counts set to 0 just before each run: the operators launched the
    kernels, not the twins), the artifact's steps/s beside the eager
    loop's and, where the engine captured its step, the replay's (then
    each run twice, in turns: eager, artifact, replay, replay, artifact,
    eager);
    every engine captures its step but those of the host-gated cg and
    gauss_seidel loops. The fused 3D artifact's size beside the plain
    route's at the same grid."""
    from ns_tpu_torch import runtime
    from ns_tpu_torch.solvers import spectral3d as s3

    print("phase 4/5: export: the main runs' configurations exported "
          "with their kernels and gated loops, loaded and run on the card")
    out = {"device": card}
    for label, kind, cfg_kw, nt, expect in EXPORT_RUNS:
        path = os.path.join(tmp, label.replace(" ", "_").replace("^", "")
                            + ".pt2z")
        t_run = time.perf_counter()
        eng, ics, export = export_case(kind, dict(cfg_kw), nt, path)
        inputs = eng._inputs(*ics)
        t0 = time.perf_counter()
        run = export()
        export_s = time.perf_counter() - t0
        want, eager_k, e1 = counted_run(lambda: eng.eager(*inputs), nt)
        got, art_k, a1 = counted_run(lambda: run(*inputs), nt)
        rates = {"eager": [e1], "artifact": [a1], "replayed": []}
        # the second turn where a replay exists (a host-gated step is not
        # captured, and its eager runs take seconds)
        turns = ("replay", "replay", "artifact", "eager") if eng.captured \
            else ()
        for mode in turns:
            fn = {"replay": lambda: eng(*inputs),
                  "eager": lambda: eng.eager(*inputs),
                  "artifact": lambda: run(*inputs)}[mode]
            rates["replayed" if mode == "replay" else mode].append(
                steps_per_s(fn, nt))
        require(len(got) == len(want) and all(
            bool(torch.isfinite(g).all()) for g in got),
            f"{label}: the artifact's fields are not finite")
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max())
                  / max(float(w.abs().max()), 1e-30)
                  for g, w in zip(got, want))
        require(bitwise or err <= EXPORT_VS_ENGINE,
                f"{label}: artifact vs engine {err:.3e} of max (bound "
                f"{EXPORT_VS_ENGINE})")
        require(art_k == eager_k, f"{label}: the artifact launched {art_k}, "
                f"the eager engine {eager_k}")
        require(expect <= set(art_k), f"{label}: the artifact launched "
                f"{sorted(art_k)}, not every kernel of {sorted(expect)}")
        gated = cfg_kw.get("pressure_mode") in ("cg", "gauss_seidel")
        require(eng.captured != gated, f"{label}: captured {eng.captured} "
                f"({eng.eager_reason}); only a host-gated loop runs eagerly")
        mean = lambda r: sum(r) / len(r) if r else None  # noqa: E731
        out[label] = {
            "nt": nt, "bitwise": bitwise, "max_err_of_max": err,
            "launches": art_k, "captured": eng.captured,
            "export_s": export_s, "artifact_bytes": os.path.getsize(path),
            "steps_per_s": {k: mean(r) for k, r in rates.items()},
            "runs": rates, "seconds": time.perf_counter() - t_run}
        print(f"  {label}: "
              + ("bitwise the engine" if bitwise
                 else f"{err:.2e} of max from the engine (not bitwise)")
              + f"; launches {art_k} (eager the same); steps/s artifact "
              f"{mean(rates['artifact']):.1f}, eager "
              f"{mean(rates['eager']):.1f}, replayed "
              + (f"{mean(rates['replayed']):.1f}" if rates["replayed"]
                 else f"- ({eng.eager_reason})")
              + f"; export {export_s:.1f} s, {os.path.getsize(path)} "
              f"bytes; {out[label]['seconds']:.1f} s in all; {card}")
    # the plain route's artifact at the fused run's grid and precision
    cfg = s3.Spectral3DConfig(nt=8, nx=N3D, ny=N3D, nz=N3D,
                              transform="matmul", matmul_precision="default",
                              use_pallas_transform=False)
    path = os.path.join(tmp, "tg3d_plain.pt2z")
    runtime.export_rollout3d(cfg, path, DEVICE)
    out["tg3d_plain_artifact_bytes"] = os.path.getsize(path)
    print(f"  the 3D artifact: fused "
          f"{out['taylor_green_3d 256^3 fused']['artifact_bytes']} bytes, "
          f"plain {out['tg3d_plain_artifact_bytes']} bytes")
    return out


# --- phase 4/5: scale-out ----------------------------------------------------

# bench.py's physics and engine (1024^2 decaying turbulence, compact
# matmul-DFT at 'default', dt 5e-4, nu 1e-4, k_peak 30), as the B = 64
# ensemble of the JAX package's scale-out record (BASELINE.md:62), 20 steps
SCALE = dict(B=64, n=N2D, nt=20, member=3, repeats=5, fd_B=(8, 64, 512),
             fd_nt=50, fd_check=(0, 1, 255, 511), dist_n=N2D,
             gang_timeout=300)
SCALE_BUDGET_S = 90
# member 3 of the B = 64 ensemble against its own single rollout, each
# carry part of its max. At 'default' the batched bf16 GEMMs (cuBLAS bmm)
# sum in another order than the single rollout's (mm; a batch of 1 gives
# the single rollout bitwise), and a sum rounded to another bf16 neighbour
# at the next stage grows over the 20 steps. Read on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, scale-out): w_hat 1.06e-4, N_prev 1.29e-3, where the
# same single rollout on the card against the CPU (another order too) reads
# 3.5e-5 and 1.01e-3; bounds with 4.7x and 3.1x headroom. The control, the
# single rollout with each bf16 GEMM's output rounded to bf16, read 3.66e-3
# and 8.5e-3 and must exceed them. The float32 'high' ensemble (fp32 GEMMs)
# is held to ENSEMBLE_VS_SINGLE of max|w| (read 9.6e-7).
ENSEMBLE_DEFAULT_VS_SINGLE = {"w_hat": 5e-4, "N_prev": 4e-3}
ENSEMBLE_VS_SINGLE = 1e-5
# run_solver --dist 'default' 1024^2, nt 200 (the JAX CLI's --dist command), u and
# v of max|u|:
#  - against a single-device run of the same engine that recovers u, v as
#    --dist does, through the compact inverse transform at 'default'
#    (`make_compact_transforms`): DIST_VS_COMPACT, 1e-4. The
#    sharded path runs the engine's own GEMM stages, nonlinear term and
#    step, so at a world of 1 only the all_to_all copies and the six- rather
#    than two-field inverse batch lie between them;
#  - against the plain CLI run, which recovers them by an fp32 irfft2:
#    DIST_VS_PLAIN. The compact inverse takes bf16 operands (2^-9 a
#    coefficient), so the two part by ~4e-3 of max|u| (read 4.2e-3 on an
#    NVIDIA H100 80GB HBM3 at 700 W, PERF.md scale-out). Its control: the plain
#    run's frames one step apart (an extraction off by one step) must part
#    by more than the bound.
DIST_RUN = ("default", 200)
DIST_VS_COMPACT = 1e-4
DIST_VS_PLAIN = 1e-2

def scale_ensemble(card: str) -> dict:
    """ensemble_init + ensemble_rollout_final at B = 64, 1024^2, 'default':
    ensemble-steps/s (median of 5 and the runs), cell-updates/s, peak
    memory, the device's idle share, member 3 against its own single
    rollout; then the same ensemble at 'high', member 3 within 1e-5 of
    max|w| of its own rollout."""
    import statistics

    from ns_tpu_torch.parallel.ensemble import (ensemble_energy,
                                                ensemble_init,
                                                ensemble_rollout_final)
    from ns_tpu_torch.solvers import spectral_periodic as sp

    B, n, m = SCALE["B"], SCALE["n"], SCALE["member"]

    def config(prec):
        return sp.SpectralPeriodicConfig(nt=SCALE["nt"], nx=n, ny=n,
                                         dt=5e-4, nu=1e-4, dtype="float32",
                                         transform="matmul",
                                         matmul_precision=prec,
                                         compact_spectrum=True)

    cfg = config("default")
    w0 = np.stack([sp.decaying_turbulence_vorticity(cfg, seed=s,
                                                    k_peak=30.0)
                   for s in range(B)])

    def member_vs_single(cfg, final):
        """(carry part errors of max, physical w error of max|w|,
        bitwise) of member m against its own rollout."""
        single = sp.rollout_final(cfg, sp.init_from_vorticity(cfg, w0[m],
                                                              DEVICE))
        parts = {k: float((a[m] - b).abs().max() / b.abs().max())
                 for k, a, b in zip(("w_hat", "N_prev"), final, single)}
        w_ens = sp.physical_from_carry(cfg, final[0][m])
        w_one = sp.physical_from_carry(cfg, single[0])
        w_err = float((w_ens - w_one).abs().max() / w_one.abs().max())
        return parts, w_err, bool(torch.equal(w_ens, w_one))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    final = []

    def run():
        carry = ensemble_init(cfg, w0, device=DEVICE)
        final[:] = [ensemble_rollout_final(cfg, carry)]

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()  # warm-up
    rates = [cfg.nt / timed() for _ in range(SCALE["repeats"])]
    peak = torch.cuda.max_memory_allocated() - base
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = timed()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    w_hat = final[0][0]
    require(w_hat.shape[0] == B and bool(torch.isfinite(
        torch.view_as_real(w_hat)).all()), "B = 64 ensemble not finite")
    parts, w_err, bitwise = member_vs_single(cfg, final[0])
    from ns_tpu_torch.ops import gemm
    exact_mm = gemm._bf16_mm_f32
    gemm._bf16_mm_f32 = lambda a, b: exact_mm(a, b).bfloat16().float()
    try:
        control = sp.rollout_final(cfg, sp.init_from_vorticity(cfg, w0[m],
                                                               DEVICE))
    finally:
        gemm._bf16_mm_f32 = exact_mm
    control, _, _ = member_vs_single(cfg, [c[None].expand(m + 1, *c.shape)
                                           for c in control])
    for part, bound in ENSEMBLE_DEFAULT_VS_SINGLE.items():
        require(parts[part] <= bound,
                f"ensemble member {m} 'default' {part} vs its own rollout: "
                f"{parts[part]:.3e} of max > {bound}")
        require(control[part] > bound,
                f"ensemble control (bf16 GEMM outputs) {part}: "
                f"{control[part]:.3e} <= {bound}")
    energy = float(ensemble_energy(cfg, w_hat))
    require(math.isfinite(energy) and energy > 0, f"energy {energy}")
    final.clear()
    cfg_high = config("high")
    high = ensemble_rollout_final(cfg_high, ensemble_init(cfg_high, w0,
                                                          device=DEVICE))
    _, high_err, high_bitwise = member_vs_single(cfg_high, high)
    require(high_err <= ENSEMBLE_VS_SINGLE,
            f"ensemble member {m} 'high' vs its own rollout: {high_err:.3e} "
            f"of max|w| > {ENSEMBLE_VS_SINGLE}")
    rate = statistics.median(rates)
    out = {"config": "B=64 decaying_turbulence 1024^2 compact matmul "
                     "'default' dt 5e-4 nu 1e-4 k_peak 30, 20 steps "
                     "(bench.py:36-40; BASELINE.md:62's workload)",
           "ensemble_steps_per_s_median_of_5": rate,
           "ensemble_steps_per_s": rates,
           "cell_updates_per_s": rate * B * n * n,
           "peak_bytes": peak, "device_idle_share":
               1.0 - busy_us / 1e3 / (wall * 1e3),
           "device_busy_ms_per_step": busy_us / 1e3 / cfg.nt,
           "member_vs_single_default": {**parts, "w_of_max": w_err,
                                        "bitwise": bitwise,
                                        "control_bf16_outputs": control},
           "member_vs_single_high": {"w_of_max": high_err,
                                     "bitwise": high_bitwise},
           "mean_energy": energy, "card": card}
    print(f"  ensemble B={B} {n}^2: {rate:.2f} ensemble-steps/s (runs "
          f"{', '.join(f'{r:.2f}' for r in rates)}), "
          f"{out['cell_updates_per_s']:.3e} cell-updates/s, peak "
          f"{peak / 1e9:.2f} GB, idle {out['device_idle_share']:.3f}; "
          f"member {m} vs single: 'default' {parts} of max (w {w_err:.2e}, "
          f"bitwise {bitwise}; control {control}), 'high' w "
          f"{high_err:.2e} (bitwise "
          f"{high_bitwise}); {card}")
    return out


def fd_ensemble_runs():
    """The FD ensembles of the scale-out phase: label -> (make_batch(B),
    step, the kernels it launches, the batch sizes run, the largest batch
    whose every member is checked). chorin_fd explicit 51^2 (K1 + K3) and
    direct_fd 50^2 (K2) at every SCALE["fd_B"], every member checked up to
    B = 64; semi_implicit 51^2 (K1; its ADI GEMMs member by member, ~2.7
    ms a single step and 0.2-0.3 ms a member in the batch) at B = 8, every
    member checked (the phase's budget: at B = 64 its runs took ~6 s).
    Initial velocities 0.01 N(0, 1) from np.random.default_rng(B)."""
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.core.state import FlowState
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    runs = {}
    for method in ("explicit", "semi_implicit"):
        c = chorin_fd.ChorinFDConfig(nt=SCALE["fd_nt"], nit=200, nx=51,
                                     ny=51, dt=0.001, rho=1.0, nu=0.1,
                                     beta=1.25, method=method)
        bc = cavity_bcs(c.dx, c.dy)

        def chorin_batch(B, c=c, bc=bc):
            u0 = 0.01 * np.random.default_rng(B).normal(size=(B, 51, 51))
            z = np.zeros((B, 51, 51))
            return chorin_fd.init_state(c, u0, z, z, *bc, device=DEVICE)

        want = {"sor_redblack_fused"}
        if method == "explicit":
            want.add("momentum_explicit_fused")
        runs[f"chorin_fd {method} 51^2"] = (
            chorin_batch, chorin_fd.make_step(c, *bc, device=DEVICE), want,
            *((SCALE["fd_B"], 64) if method == "explicit"
              else (SCALE["fd_B"][:1], 8)))
    d = direct_fd.DirectFDConfig(nt=SCALE["fd_nt"], nit=50, nx=50, ny=50)

    def direct_batch(B):
        rng = np.random.default_rng(B)
        return FlowState(*(torch.as_tensor(0.01 * rng.normal(size=(B, 50, 50)),
                                           dtype=torch.float32, device=DEVICE)
                           for _ in range(3)))

    runs["direct_fd 50^2"] = (direct_batch, direct_fd.make_step(
        d, *cavity_bcs(d.dx, d.dy)), {"jacobi_fused"}, SCALE["fd_B"], 64)
    return runs


def scale_fd_ensembles(card: str) -> dict:
    """ensemble_fd_rollout of chorin_fd explicit 51^2 (K1 + K3), direct_fd
    50^2 (K2) and chorin_fd semi_implicit 51^2 (K1) at the batch sizes of
    `fd_ensemble_runs`, nt 50: member-steps/s (the median of
    SCALE["repeats"] runs and the runs); around each run the counts set to
    0 just before and read just after, each kernel of the step launched
    exactly nt times (one launch a step for the whole batch) and no other;
    every member bitwise its own single rollout up to the run's checked
    size, beyond it the members SCALE["fd_check"] (at B = 512 odd members
    sit 4 bytes off a 16-byte boundary)."""
    import statistics

    from ns_tpu_torch.core.state import FlowState
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout

    nt = SCALE["fd_nt"]
    out = {}
    for label, (make_batch, step, want, sizes,
                every) in fd_ensemble_runs().items():
        require(getattr(step, "batch_polymorphic", False),
                f"{label}: the step does not take a batch")
        for B in sizes:
            batch = make_batch(B)
            fields = [f for f in ("u", "v", "p", "u_prev", "v_prev")
                      if getattr(batch, f) is not None]
            got, rates = None, []
            for _ in range(SCALE["repeats"] + 1):  # the first a warm-up
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                got = ensemble_fd_rollout(step, batch, nt)
                torch.cuda.synchronize()
                rates.append(B * nt / (time.perf_counter() - t0))
                launches = {k: v for k, v in kernels.launch_counts().items()
                            if v}
                calls = {k: v for k, v in kernels.call_counts().items() if v}
                require(launches == {k: nt for k in want} == calls,
                        f"FD ensemble {label} B={B}: launches {launches}, "
                        f"calls {calls}; want {nt} of each of {sorted(want)}")
            rates = rates[1:]
            checked = (range(B) if B <= every else
                       [m for m in SCALE["fd_check"] if m < B])
            for m in checked:
                s = FlowState(**{f: getattr(batch, f)[m].clone()
                                 for f in fields})
                for _ in range(nt):
                    s = step(s)
                for f in fields:
                    require(torch.equal(getattr(got, f)[m], getattr(s, f)),
                            f"FD ensemble {label} B={B}: member {m} field "
                            f"{f} is not its single rollout bitwise")
            rate = statistics.median(rates)
            out[f"{label} B={B}"] = {
                "B": B, "nt": nt, "launches": launches,
                "member_steps_per_s_median": rate,
                "member_steps_per_s": rates,
                "members_checked_bitwise": len(checked), "card": card}
            runs = ", ".join(f"{r:.1f}" for r in rates)
            print(f"  FD ensemble {label} B={B} nt={nt}: {rate:.1f} "
                  f"member-steps/s (runs {runs}), launches {launches} a "
                  f"run, {len(checked)} members "
                  f"bitwise their single rollouts; {card}")
    return out


def _launch_start(args, timeout) -> subprocess.Popen:
    """Start python -m ns_tpu_torch.launch ... from the repo root, with the
    launcher's own --timeout a little under `timeout`."""
    return subprocess.Popen(
        [sys.executable, "-m", "ns_tpu_torch.launch", "--timeout",
         str(timeout - 15)] + args, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))


def _launch_wait(proc, args, timeout) -> str:
    """The launch's stdout; fails unless it exits 0 within `timeout`."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"launch {' '.join(args)} did not finish in {timeout} s")
    require(proc.returncode == 0, f"launch {' '.join(args)} failed "
            f"(rc {proc.returncode}):\n{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


def _launch(args, timeout) -> str:
    return _launch_wait(_launch_start(args, timeout), args, timeout)


def scale_dist(tmp, card: str) -> dict:
    """run_solver --dist through the launcher on a world of 1 (NCCL,
    all_to_all), its assembled npz's u and v against a single-device run
    that recovers them through the compact inverse (DIST_VS_COMPACT) and
    against the same command's plain run (DIST_VS_PLAIN, with its control),
    of max|u| (p is the compact truncated Poisson solve under --dist, the
    full rfft2 one in the plain run, in both packages). The launcher's
    self-tests start once the --dist run has read its rate, and run
    alongside the plain run and the checks (`selftest_s`)."""
    from ns_tpu_torch.cli import run_solver
    from ns_tpu_torch.solvers import spectral_periodic as sp

    n = SCALE["dist_n"]
    prec, nt = DIST_RUN
    argv = ["decaying_turbulence", "--nx", str(n), "--nt", str(nt),
            "--compact", "--transform", "matmul", "--precision", prec]
    dist_out = os.path.join(tmp, "dist.npz")
    stdout = _launch(["--nprocs", "1", "--platform", "cuda", "--",
                      sys.executable, "-m", "ns_tpu_torch.cli.run_solver"]
                     + argv + ["--dist", "--out", dist_out],
                     SCALE["gang_timeout"])
    line = [ln for ln in stdout.splitlines() if "steps/s" in ln]
    require(line, f"--dist printed no rate:\n{stdout[-2000:]}")
    dist_rate = float(line[0].split("(")[-1].split(" steps/s")[0])
    selftests = start_selftests()
    plain_out = os.path.join(tmp, "plain.npz")
    summary = run_solver.main(argv + ["--device", DEVICE, "--out",
                                      plain_out])
    with np.load(dist_out) as a, np.load(plain_out) as b:
        require(a["u"].shape == (nt, n, n), f"--dist u shape {a['u'].shape}")
        fields = {k: (torch.as_tensor(a[k], device=DEVICE),
                      torch.as_tensor(b[k], device=DEVICE)) for k in "uv"}
    for path in (dist_out, plain_out):
        os.remove(path)
    umax = float(fields["u"][1].abs().max())
    of_max = lambda d: float(d.abs().max()) / umax  # noqa: E731
    # the single-device engine, u and v through the compact inverse
    _, _, sys_ = run_solver.build(argv + ["--device", DEVICE])
    inv = sp.make_compact_transforms(sys_.cfg, DEVICE)[1]
    ops = sp.make_compact_ops(sys_.cfg, DEVICE)
    carry = sys_.carry0
    vs_compact = dict.fromkeys("uv", 0.0)
    for i in range(nt):
        carry, w_new = sys_._step(carry)
        uv = inv(torch.stack(sp.velocity_from_vorticity_hat(w_new, ops)))
        for k, ref in zip("uv", uv):
            vs_compact[k] = max(vs_compact[k], of_max(fields[k][0][i] - ref))
    vs_plain = {k: of_max(d - p) for k, (d, p) in fields.items()}
    control = {k: of_max(p[1:] - p[:-1]) for k, (_, p) in fields.items()}
    del fields
    require(max(vs_compact.values()) <= DIST_VS_COMPACT,
            f"--dist vs the compact-inverse run: {vs_compact} of max|u| > "
            f"{DIST_VS_COMPACT}")
    require(max(vs_plain.values()) <= DIST_VS_PLAIN,
            f"--dist vs plain: {vs_plain} of max|u| > {DIST_VS_PLAIN}")
    require(min(control.values()) > DIST_VS_PLAIN,
            f"control (plain frames one step apart): {control} of max|u| "
            f"<= {DIST_VS_PLAIN}")
    out = {"world": 1, "backend": "nccl", "card": card, "argv": argv,
           "dist_steps_per_s": dist_rate,
           "plain_cli_steps_per_s": summary["steps_per_s"],
           "vs_compact_inverse_of_max_u": vs_compact,
           "vs_plain_of_max_u": vs_plain,
           "control_one_step_of_max_u": control,
           "bounds": {"vs_compact_inverse": DIST_VS_COMPACT,
                      "vs_plain": DIST_VS_PLAIN}}
    print(f"  run_solver --dist (launch, 1 rank, NCCL) {n}^2 nt={nt} "
          f"'{prec}': {dist_rate:.1f} steps/s (the sharded rollout) "
          f"against the plain CLI's {summary['steps_per_s']:.1f} (set-up "
          f"and I/O included, the self-tests running alongside); u, v vs "
          f"the compact-inverse run {vs_compact} (bound {DIST_VS_COMPACT}),"
          f" vs plain {vs_plain} (bound {DIST_VS_PLAIN}; control "
          f"{control}) of max|u|; {card}")
    out["selftest_s"] = wait_selftests(selftests)
    return out


SELFTESTS = {"cuda, 1 rank (NCCL)": ["--nprocs", "1", "--platform", "cuda"],
             "a CPU gang of 4 ranks (gloo), asked for by this script":
                 ["--nprocs", "4", "--platform", "cpu"]}


def start_selftests():
    """The launcher's self-test on the card (1 rank, NCCL) and, at the same
    time, on a CPU gang of 4 (gloo) that this script asks for."""
    return time.perf_counter(), {
        label: _launch_start(args + ["--selftest"], 120)
        for label, args in SELFTESTS.items()}


def wait_selftests(started) -> dict:
    """Seconds from the start to each self-test's end; fails unless every
    rank printed SELFTEST OK."""
    t0, procs = started
    out = {}
    for label, args in SELFTESTS.items():
        stdout = _launch_wait(procs[label], args + ["--selftest"], 120)
        n = int(args[1])
        require(all(f"SELFTEST OK p{i}" in stdout for i in range(n)),
                f"self-test {label}: {stdout[-2000:]}")
        out[label] = time.perf_counter() - t0
        print(f"  launch --selftest on {label}: SELFTEST OK on every rank "
              f"(done {out[label]:.1f} s after both started)")
    return out


def scale_debug_tools(tmp) -> dict:
    """enable_nan_checks raises on a NaN made on the card; timed and trace
    run there, the trace holding chorin_fd's pressure scope."""
    import glob

    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.solvers import chorin_fd
    from ns_tpu_torch.utils import guard, profiling

    guard.enable_nan_checks()
    try:
        torch.log(torch.tensor([-1.0], device=DEVICE))
        raised = False
    except FloatingPointError:
        raised = True
    finally:
        guard.enable_nan_checks(False)
    require(raised, "enable_nan_checks did not raise on a NaN on the card")
    c = chorin_fd.ChorinFDConfig(nt=1, nit=200, nx=51, ny=51, dt=0.001,
                                 rho=1.0, nu=0.1, method="explicit")
    bc = cavity_bcs(c.dx, c.dy)
    z = np.zeros((51, 51))
    step = chorin_fd.make_step(c, *bc, device=DEVICE)
    s0 = chorin_fd.init_state(c, z, z, z, *bc, device=DEVICE)
    secs, _ = profiling.timed(step, s0, iters=20, warmup=2)
    log_dir = os.path.join(tmp, "trace")
    with profiling.trace(log_dir):
        step(s0)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    require(len(files) == 1, f"trace wrote {files}")
    with open(files[0]) as f:
        require("chorin_fd.pressure" in f.read(),
                "the trace holds no chorin_fd.pressure scope")
    print(f"  enable_nan_checks raised on the card; timed: chorin_fd "
          f"explicit 51^2 step {secs * 1e3:.3f} ms; trace holds "
          "chorin_fd.pressure")
    return {"nan_check_raised": True, "timed_step_ms": secs * 1e3}


def phase_scale_out(tmp, card: str) -> dict:
    """Ensembles, the FD ensembles' kernels, run_solver --dist with the
    self-tests alongside its checks, and the debug tools (module
    docstring)."""
    print("phase 4/5: scale-out (ensembles at B = 64, FD ensembles, "
          "launch + run_solver --dist, self-tests, debug tools)")
    out, seconds = {}, {}
    for key, fn in (("ensemble", lambda: scale_ensemble(card)),
                    ("fd_ensemble", lambda: scale_fd_ensembles(card)),
                    ("dist", lambda: scale_dist(tmp, card)),
                    ("debug_tools", lambda: scale_debug_tools(tmp))):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
    out["seconds"] = seconds
    print(f"  part seconds: {seconds}")
    return out


# --- the sharded solvers and data-parallel training ---------------------------
# The last modules of the JAX package (parallel/chorin_fd_sharded.py,
# chorin_spectral_sharded.py, spectral3d_sharded.py; TrainConfig.dp and the
# ensemble mesh) in one launched child, one rank on NCCL (`sharded_child`).
# No kernel lies on these paths in either package. The solvers' runs,
# bounds and budgets are tools/torch_sharded_solvers.py's (its docstring).
# Then, in the same child, each joining the process group anew from the
# launcher's variables: cli.train --dist --dp 1 on the train phase's fno_w
# configuration and npz (TRAIN), 10 iterations, held bitwise to the plain
# cli.train run here (metrics.jsonl and checkpoint), all-reduces only
# (tests/test_collectives.py:224); and cli.train --n-models 2 --mesh auto
# --dist on two fno_w members (the train phase's ensemble_check
# configuration), whose ensemble_mesh is None at a world of 1, its
# checkpoint bitwise the plain run's. Iterations/s: the median of
# iterations 2-10, each timed to a synchronize (`step_timer`): a warm
# rate, as the train phase's profiled chunk gives one.
SHARDED_BUDGET_S = 90
SHARDED_TIMEOUT = 300


@contextlib.contextmanager
def step_timer(times: list):
    """Each Trainer iteration's seconds, to a synchronize, into `times`."""
    from ns_tpu_torch.train.trainer import Trainer
    step = Trainer._step

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)

    def timed_step(self):
        sync()
        t0 = time.perf_counter()
        out = step(self)
        sync()
        times.append(time.perf_counter() - t0)
        return out

    Trainer._step = timed_step
    try:
        yield
    finally:
        Trainer._step = step


def cli_train_report(argv) -> dict:
    """cli.train.main(argv) in this process: the collectives it counted,
    the trainer's mesh, its iterations' seconds."""
    from ns_tpu_torch.cli import train
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts

    times = []
    reset_counts()
    with step_timer(times), contextlib.redirect_stdout(io.StringIO()):
        tr = train.main(argv)
    mesh = getattr(tr, "mesh", None)
    return {"counts": dict(COUNTS), "step_s": times,
            "mesh": None if mesh is None else dict(zip(
                mesh.mesh_dim_names, mesh.shape))}


def sharded_child(spec: dict):
    """The launched child of phase_sharded (one rank): the sharded solvers
    (tools/torch_sharded_solvers.py, its own process group), then each
    cli.train command of spec, one line "CHILD <label> <json>" each."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_sharded_solvers
    torch_sharded_solvers.main()
    for label, argv in spec.items():
        report = cli_train_report(argv)
        report["jax"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "ns_tpu"))
        print(f"CHILD {label} " + json.dumps(report), flush=True)


def _child_json(stdout: str, key: str) -> dict:
    """The JSON object a child printed after `key` (the launcher prefixes
    its lines with [p0])."""
    for line in stdout.splitlines():
        if key in line:
            return json.loads(line[line.index(key) + len(key):])
    fail(f"no {key!r} line in:\n{stdout[-3000:]}")


def sharded_solvers(r: dict, card: str) -> None:
    """The solvers' line: every run within its bound, no kernel launched
    by a sharded run, the collectives a step equal to the JAX budgets."""
    budgets = r["budgets"]
    runs = dict(r["chorin_fd"])
    counts = {label: runs.pop(label + " counts a step")
              for label in ("chorin_fd redblack", "chorin_fd dst")}
    counts["chorin_spectral"] = r["chorin_spectral"]["counts_a_step"]
    runs["chorin_spectral 1024^2 float64"] = r["chorin_spectral"]
    for label, run in r["spectral3d"].items():
        runs[f"spectral3d 256^3 {label}"] = run
    for label, run in runs.items():
        more = "".join(f", {k} {run[k]}" for k in (
            "bitwise", "err_vs_kernel_route", "plain_route_steps_per_s")
            if k in run)
        print(f"  sharded {label}: err {run['err']:.3e} (bound "
              f"{run['bound']}{more}); {run['steps_per_s']:.2f} steps/s "
              f"against the single device's "
              f"{run['single_device_steps_per_s']:.2f}; {card}")
    c = r["chorin_spectral"]
    print(f"  chorin_spectral 1024^2 dense set-up: sharded {c['setup_s']:.1f}"
          f" s, single-device {c['single_device_setup_s']:.1f} s; "
          f"collectives a step {counts}; process group "
          f"{r['process_group_init_s']:.2f} s; parts {r['seconds']}")
    require(r["world"] == 1 and r["backend"] == "nccl",
            f"sharded solvers ran on {r['world']} ranks, {r['backend']}")
    for label, got in counts.items():
        require(got == budgets[label],
                f"{label}: {got} collectives a step, JAX {budgets[label]}")
    for label, run in r["spectral3d"].items():
        want = budgets["spectral3d " + label.split()[0]]["all_to_all"]
        require(run["sites"] == want and set(run["counts"]) == {"all_to_all"},
                f"spectral3d {label}: {run['counts']}, {run['sites']} "
                f"sites, JAX {want}")
    for label, run in runs.items():
        require(run["err"] <= run["bound"],
                f"sharded {label}: {run['err']:.3e} > {run['bound']}")
        require(not run["kernels_launched"],
                f"sharded {label} launched {run['kernels_launched']}")


def _same_run(a: str, b: str, label: str) -> None:
    """Two cli.train output folders: metrics.jsonl's losses (where the
    trainer writes one: the ensemble writes none, as in the JAX package)
    and every checkpoint array bitwise equal."""
    def losses(folder):
        path = os.path.join(folder, "metrics.jsonl")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return [{k: v for k, v in json.loads(x).items() if k != "time"}
                    for x in f]
    require(losses(a) == losses(b),
            f"{label}: metrics.jsonl {losses(a)} vs {losses(b)}")
    with np.load(os.path.join(a, "checkpoint.npz")) as x, \
            np.load(os.path.join(b, "checkpoint.npz")) as y:
        require(sorted(x.files) == sorted(y.files),
                f"{label}: checkpoint keys differ")
        for k in y.files:
            require(np.array_equal(x[k], y[k]),
                    f"{label}: checkpoint {k} differs")
    ma, mb = (json.load(open(os.path.join(f, "checkpoint.npz.meta.json")))
              for f in (a, b))
    require(ma["losses"] == mb["losses"] and ma.get("torch_generator")
            == mb.get("torch_generator"), f"{label}: meta differs")


def _it_per_s(step_s: list) -> float:
    """1 / the median of iterations 2.. (the first builds tables and
    plans)."""
    import statistics
    return 1.0 / statistics.median(step_s[1:])


def phase_sharded(tmp, card: str) -> dict:
    """The launched child (module comment above), then the plain cli.train
    runs here, and the checks."""
    print("phase 4/5: the sharded solvers and data-parallel training "
          "(launch, one rank on NCCL)")
    t0 = time.perf_counter()
    npz = os.path.join(tmp, "turbulence_128.npz")
    if not os.path.exists(npz):
        npz = training_data(tmp)
    dp = ["--model", "fno_w", "--npz-path", npz, "--n-frames",
          str(TRAIN["frames"]), "--fno-width", str(TRAIN["width"]),
          "--fno-modes", str(TRAIN["modes"]), "--n-iters", "10",
          "--ckpt-every", "10", "--device", DEVICE]
    ens = ["--model", "fno_w", "--npz-path", npz, "--n-frames", "20",
           "--fno-width", "16", "--fno-modes", "12", "--n-iters", "4",
           "--ckpt-every", "2", "--n-models", "2", "--mesh", "auto",
           "--device", DEVICE]
    out_dir = lambda name: os.path.join(tmp, f"sharded_{name}")  # noqa: E731
    spec = {"dp": dp + ["--dist", "--dp", "1", "--out-dir", out_dir("dp")],
            "ensemble": ens + ["--dist", "--out-dir", out_dir("ens")]}
    stdout = _launch(["--nprocs", "1", "--platform", "cuda", "--",
                      sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                      "--sharded-child", json.dumps(spec)], SHARDED_TIMEOUT)
    child_s = time.perf_counter() - t0
    out = {"solvers": _child_json(stdout, "SHARDED ")}
    sharded_solvers(out["solvers"], card)
    child = {k: _child_json(stdout, f"CHILD {k} ") for k in spec}
    for label, rep in child.items():
        require(not rep["jax"], f"the child's {label} imported {rep['jax']}")
    plain = {"dp": cli_train_report(dp + ["--out-dir", out_dir("dp_plain")]),
             "ensemble": cli_train_report(ens + ["--out-dir",
                                                 out_dir("ens_plain")])}
    _same_run(out_dir("dp_10"), out_dir("dp_plain_10"),
              "cli.train --dist --dp 1")
    _same_run(out_dir("ens_10"), out_dir("ens_plain_10"),
              "cli.train --n-models 2 --mesh auto --dist")
    d, e = child["dp"], child["ensemble"]
    require(d["mesh"] == {"data": 1} and d["counts"] == {
        "all_reduce": 20, "all_reduce@data": 20},
        f"--dist --dp 1: mesh {d['mesh']}, collectives {d['counts']}")
    require(plain["dp"]["mesh"] is None and not plain["dp"]["counts"],
            f"plain cli.train: {plain['dp']}")
    require(e["mesh"] is None and not e["counts"],
            f"--n-models 2 --mesh auto on a world of 1: {e}")
    for name in ("dp_10", "dp_plain_10"):
        shutil.rmtree(out_dir(name))
    out["dp_training"] = {
        "dist_dp1_it_per_s": _it_per_s(d["step_s"]),
        "plain_it_per_s": _it_per_s(plain["dp"]["step_s"]),
        "dist_dp1_step_s": d["step_s"], "plain_step_s": plain["dp"]["step_s"],
        "counts": d["counts"], "ensemble_mesh": e["mesh"]}
    out["seconds"] = {"child": child_s,
                      "plain_and_checks": time.perf_counter() - t0 - child_s}
    r = out["dp_training"]
    print(f"  cli.train fno_w 128^2 w64 m43, 10 iterations: --dist --dp 1 "
          f"(launch, NCCL) {r['dist_dp1_it_per_s']:.2f} it/s, plain "
          f"{r['plain_it_per_s']:.2f} it/s (median of iterations 2-10); "
          f"losses and checkpoint bitwise equal; 2 all-reduces an "
          f"iteration, no all_gather, no all_to_all; --n-models 2 --mesh "
          f"auto --dist: ensemble_mesh None at a world of 1, checkpoint "
          f"bitwise the plain run's; seconds {out['seconds']}; {card}")
    return out


# --- report ------------------------------------------------------------------

KERNELS = [  # wrapper name, CUDA source, the TPU kernel it replaces
    ("sor_redblack_fused", "ns_tpu_torch/csrc/poisson_kernels.cu",
     "ns_tpu/ops/pallas/poisson_kernels.py:115"),
    ("jacobi_fused", "ns_tpu_torch/csrc/poisson_kernels.cu",
     "ns_tpu/ops/pallas/poisson_kernels.py:79"),
    ("jacobi_multiblock", "ns_tpu_torch/csrc/poisson_kernels.cu",
     "ns_tpu/ops/pallas/poisson_kernels.py:79"),
    ("momentum_explicit_fused", "ns_tpu_torch/csrc/momentum_kernels.cu",
     "ns_tpu/ops/pallas/momentum_kernels.py:75"),
    ("sor_redblack_packed_multiblock", "ns_tpu_torch/csrc/poisson_kernels.cu",
     "ns_tpu/ops/pallas/poisson_kernels.py:356"),
    ("sor_redblack_multiblock", "ns_tpu_torch/csrc/poisson_kernels.cu",
     "ns_tpu/ops/pallas/poisson_kernels.py:180"),
    ("fused_zy_forward", "ns_tpu_torch/csrc/transform3d_kernels.cu",
     "ns_tpu/ops/pallas/transform3d_kernels.py:310"),
    ("fused_yz_inverse", "ns_tpu_torch/csrc/transform3d_kernels.cu",
     "ns_tpu/ops/pallas/transform3d_kernels.py:347"),
    ("fused_lamb", "ns_tpu_torch/csrc/transform3d_kernels.cu",
     "ns_tpu/ops/pallas/transform3d_kernels.py:258"),
]


def report(res: Results, main_path: dict, replayed: dict,
           fd_ensemble: dict) -> list:
    """The kernels line: every number measured or computed in this run.
    `ms`/`plain_ms` are at the main path's precision; K6, K7 and K8 also
    give both precisions' kernel times (ms_default, ms_highest), the
    'highest' route's twin time and bound, and their tensor-core launches
    on the main path; the kernels the runtime engines replay
    (KERNEL_SYMBOLS) their launches in one replayed call of each engine
    (`launches_replayed`, the profiler's device records); K1, K2 and K3
    their batched route (`batched`: its launches in each FD ensemble run,
    its errors against the batched twin, its times and bounds at the
    ensemble's batch sizes)."""
    rows = []
    launches = main_path["launches"]
    for name, src, rep in KERNELS:
        f64 = name in res.err64
        bound_ms, bound_by = res.bound.get(name, (None, None))
        calls = main_path["calls"].get(name, 0)
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches.get(name, 0), "calls": calls,
               "launches_per_call": launches.get(name, 0) / max(calls, 1),
               "max_abs_err": res.err64[name] if f64 else res.abs32.get(name),
               "max_abs_err_dtype": "float64" if f64 else "float32",
               "max_rel_err_f32": res.rel32.get(name),
               "ms": res.ms.get(name), "plain_ms": res.plain_ms.get(name),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": res.library_ms.get(name)}
        keys = ["max_abs_err", "max_rel_err_f32", "ms", "plain_ms",
                "bound_ms"]
        if name not in res.extra:  # the FD kernels: the profiler's time too
            row["device_ms"] = res.device_ms.get(name)
            keys.append("device_ms")
        if name in RESIDENT:
            row["launches_resident"] = main_path["launches_resident"][name]
        if name in COLOR_GROUPS:
            require(name in res.vs_groups,
                    f"{name} was not timed beside the colour groups")
            row["color_groups_ms_same_input"] = res.vs_groups[name][1]
            keys.append("color_groups_ms_same_input")
        if name in ONE_LAUNCH:
            require(row["launches_per_call"] == 1,
                    f"{name}: {row['launches_per_call']} launches a call on "
                    "the main path")
        if name in res.more:
            row.update(res.more[name])
            keys += list(res.more[name])
        if name in ("fused_zy_forward", "fused_yz_inverse"):
            keys.append("library_ms")
        if name in res.extra:
            row.update(res.extra[name],
                       launches_bf16=main_path["launches_bf16"][name])
            keys += list(res.extra[name]) + ["launches_bf16"]
            require(row["launches_bf16"] > 0,
                    f"{name}: no tensor-core launch on the main path")
        for key in keys:
            require(row[key] is not None and math.isfinite(row[key]),
                    f"{name}: no {key}")
        require(row["launches"] > 0 and row["calls"] > 0,
                f"{name}: no launch on the main path")
        if name in KERNEL_SYMBOLS:
            row["launches_replayed"] = replayed[name]
            require(replayed[name] > 0,
                    f"{name}: no launch in the replayed CUDA graphs")
        if name in BATCHED:
            tag = f"{name}[batched]"
            ens = {run: r["launches"][name] for run, r in fd_ensemble.items()
                   if name in r["launches"]}
            require(ens and all(n == SCALE["fd_nt"] for n in ens.values()),
                    f"{name}: batched launches in the FD ensembles {ens}")
            batched = {"route": BATCHED[name], "launches_ensemble": ens,
                       "max_abs_err": res.err64.get(tag),
                       "max_abs_err_dtype": "float64",
                       "max_rel_err_f32": res.rel32.get(tag),
                       **res.batched.get(name, {})}
            for key in ["max_abs_err", "max_rel_err_f32"] + [
                    f"{k}_B{B}" for B in SCALE["fd_B"]
                    for k in ("ms", "device_ms", "bound_ms")]:
                require(batched.get(key) is not None
                        and math.isfinite(batched[key]),
                        f"{name}: no batched {key}")
            row["batched"] = batched
        rows.append(row)
    return rows


def require_no_jax():
    require("jax" not in sys.modules, "jax was imported")
    require(not any(m.split(".")[0] == "ns_tpu" for m in sys.modules),
            "the JAX package was imported")


def timed_phase(name: str, fn, *args, budget_s=None):
    t0 = time.perf_counter()
    out = fn(*args)
    took = time.perf_counter() - t0
    budget = "" if budget_s is None else (
        f"; {'within' if took <= budget_s else 'OVER'} its {budget_s} s "
        "budget")
    print(f"[{name}: {took:.1f} s{budget}]", flush=True)
    require_no_jax()
    return out


def main():
    card = phase_device()
    phase_build()
    require_no_jax()
    res = Results()
    timed_phase("kernels", phase_kernels, res, torch.device(DEVICE))
    with tempfile.TemporaryDirectory() as tmp:
        main_path = timed_phase("main", phase_main, tmp, card)
        timed_phase("fidelity", phase_fidelity, tmp)
        timed_phase("fidelity modes", phase_fidelity_modes, tmp)
        fid3d = timed_phase("fidelity 3d", phase_fidelity_3d, tmp,
                            main_path["tg3d_npz"])
        timed_phase("fidelity 2d", phase_fidelity_2d)
        cheb = timed_phase("main chebyshev", phase_main_chebyshev, tmp,
                           card)
        timed_phase("fidelity chebyshev", phase_fidelity_chebyshev,
                    cheb.pop("npz_1024"))
        surrogate = timed_phase("surrogate", phase_surrogate, tmp, card)
        training = timed_phase("train", phase_train, tmp, card)
        surrogate3d = timed_phase("surrogate 3d", phase_surrogate3d, tmp,
                                  card, budget_s=SURR3D_BUDGET_S)
        serving = timed_phase("serve and runtime", phase_serve_runtime, tmp,
                              card, budget_s=SERVE_BUDGET_S)
        exports = timed_phase("export", phase_export, tmp, card,
                              budget_s=EXPORT_BUDGET_S)
        scale_out = timed_phase("scale-out", phase_scale_out, tmp, card,
                                budget_s=SCALE_BUDGET_S)
        sharded = timed_phase("sharded solvers and dp training",
                              phase_sharded, tmp, card,
                              budget_s=SHARDED_BUDGET_S)
    require_no_jax()
    kernels = report(res, main_path, serving["runtime"]["launches_replayed"],
                     scale_out["fd_ensemble"])
    print(json.dumps({"card": card,
                      "main_path_steps_per_s": main_path["steps_per_s"],
                      "bench_2d": main_path["bench_2d"],
                      "tg3d_high": fid3d["tg3d_high"],
                      "chebyshev": {
                          "guard_step_51": cheb["guard_step"],
                          "cli_steps_per_s": cheb["rates"],
                          "setup_s": cheb["setup_s"],
                          "step_loop": {
                              prec: {k: r[k] for k in (
                                  "steps_per_s_median_of_3", "steps_per_s",
                                  "device_records_per_step",
                                  "device_idle_share", "setup_s",
                                  "top_device_ms", "top_host_self_ms")}
                              for prec, r in cheb["profile"].items()}},
                      "surrogate": surrogate, "train": training,
                      "surrogate3d": surrogate3d, "serve_runtime": serving,
                      "export": exports,
                      "scale_out": scale_out, "sharded": sharded}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-child"]:
        sharded_child(json.loads(sys.argv[2]))
    else:
        main()
