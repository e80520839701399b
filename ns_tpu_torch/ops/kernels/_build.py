"""Build and load the hand-written CUDA kernels of ns_tpu_torch.

The sources under `ns_tpu_torch/csrc/` are compiled at first use with
`nvcc` for Hopper (`-gencode arch=compute_90a,code=sm_90a`), one nvcc per
source, all started together, and linked into one shared library with a
plain C interface, which is loaded with `ctypes`. The
library lands in `ns_tpu_torch/_build/` under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing file. nvcc's output (ptxas register and shared-memory report)
is kept beside it in a `.log` file.

There is no fallback: if nvcc is missing or the build fails, `library()`
raises with nvcc's stderr, and the CUDA path of every wrapper raises with
it.

The launch helpers below are what every wrapper shares: input validation,
the entry point for a dtype, the current stream, and the error check after
a launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
_BOTH, _F32 = ("f32", "f64"), ("f32",)
# C entry points: name -> (argtypes, the dtype suffixes it is built for);
# every one returns a cudaError_t as int
_ENTRIES = {
    "ns_jacobi_fused": ([_P, _P, _P, _I, _I, _I, _D, _D, _D, _D, _P, _I, _L,
                         _P], _BOTH),
    "ns_jacobi_multiblock": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _D, _D, _D, _D, _P, _P], _BOTH),
    "ns_jacobi_resident_occupancy": ([_I, _I, _I, _I, ctypes.POINTER(_I)],
                                     _BOTH),
    "ns_sor_redblack_fused": ([_P, _P, _P, _I, _I, _D, _D, _D, _D, _D, _I,
                               _I, _L, _P, _P], _BOTH),
    "ns_sor_redblack_tiled_group": ([_P, _P, _P, _I, _I, _D, _D, _D, _D, _I,
                                     _P], _BOTH),
    "ns_sor_redblack_packed_group": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _D, _D, _D, _D, _I, _P], _BOTH),
    "ns_sor_redblack_packed_resident": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _D, _D, _D, _D, _D, _I,
                                         _I, _P, _P], _BOTH),
    "ns_sor_packed_resident_occupancy": ([_I, _I, _I, _I, _I,
                                          ctypes.POINTER(_I)], _BOTH),
    "ns_momentum_explicit": ([_P, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _D,
                              _D, _D, _I, _P, _I, _L, _P], _BOTH),
    "ns_fused_zy_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                            _F32),
    "ns_fused_zy_forward_bf16": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P], _F32),
    "ns_fused_yz_inverse": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                            _F32),
    "ns_fused_yz_inverse_bf16": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P], _F32),
    "ns_fused_lamb": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                      _F32),
    "ns_fused_lamb_bf16": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P], _F32),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = CUDA_HOME / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found on PATH or under "
        f"{CUDA_HOME / 'bin'}: the CUDA kernels of ns_tpu_torch are built "
        "from source at first use and need the CUDA toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources (or find them already compiled) and return the
    library's path."""
    lib = BUILD_DIR / f"libns_tpu_torch_{_digest()}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        # build under private names, then rename: a concurrent build never
        # loads a half-written library
        tmp = os.path.join(tmpdir, lib.name)
        objs = {src: os.path.join(tmpdir, src.stem + ".o")
                for src in sorted(CSRC.glob("*.cu"))}
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                for s, o in objs.items()]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        log = [(c, p.communicate()[0], p.returncode)
               for c, p in zip(cmds, procs)]
        if not any(rc for *_, rc in log):
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                    *objs.values()]
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append((link, proc.stdout, proc.returncode))
        lib.with_suffix(".log").write_text(
            "".join(" ".join(c) + "\n" + out for c, out, _ in log))
        for c, out, rc in log:
            if rc:
                raise KernelBuildError(
                    f"nvcc failed (exit {rc}): {' '.join(c)}\n{out}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build_library()))
    for name, (argtypes, suffixes) in _ENTRIES.items():
        for suffix in suffixes:
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ns_error_string.argtypes = [ctypes.c_int]
    lib.ns_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().ns_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# --- launch helpers shared by the wrappers ----------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
KIND = {"dirichlet": 0, "neumann": 1}
# the sides by their C number (csrc/common.cuh::EdgePlan)
SIDES = ("left", "right", "bottom", "top")


def entry(name: str, dtype: torch.dtype):
    """The C entry point `name` for `dtype` (float32 or float64)."""
    suffix = _SUFFIX[dtype]
    if suffix not in _ENTRIES[name][1]:
        raise TypeError(f"{name} has no {dtype} kernel")
    return getattr(library(), f"{name}_{suffix}")


def check_inputs(what: str, *tensors: torch.Tensor,
                 members: bool = False) -> tuple[int, ...]:
    """Validate the kernel inputs: CUDA, one device, float32/float64 alike,
    2D of one shape, C-contiguous. Returns the shape. With `members` (the
    kernels that take a batch: K1, K2, K3) a (B, nx, ny) batch is taken
    too, and the return is (B, nx, ny), B = 1 for one field."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype must be float32|float64, got "
                        f"{t0.dtype}")
    if t0.dim() not in ((2, 3) if members else (2,)):
        raise ValueError(f"{what}: expected 2D fields"
                         f"{' or a (B, nx, ny) batch' if members else ''}, "
                         f"got {tuple(t0.shape)}")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape):
            raise ValueError(f"{what}: inputs differ in device, dtype or "
                             f"shape ({t.device}/{t.dtype}/{tuple(t.shape)} "
                             f"vs {t0.device}/{t0.dtype}/{tuple(t0.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    nx, ny = t0.shape[-2:]
    if nx < 3 or ny < 3:
        raise ValueError(f"{what}: grid must be at least 3x3, got {nx}x{ny}")
    if not members:
        return nx, ny
    if t0.numel() == 0:
        raise ValueError(f"{what}: an empty batch {tuple(t0.shape)}")
    return (t0.shape[0] if t0.dim() == 3 else 1), nx, ny


def check_fields(what: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: tuple[int, ...]) -> None:
    """Validate one input of the 3D transform kernels: CUDA, `dtype`, a
    rank in `ndim`, C-contiguous, no empty axis."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype must be {dtype}, got {t.dtype}")
    if t.dim() not in ndim:
        raise ValueError(f"{what}: expected rank {ndim}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: inputs must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{what}: empty input {tuple(t.shape)}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream
