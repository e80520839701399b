"""Matrix products at a configured precision (plain torch, cuBLAS on CUDA).

The JAX package names a precision per GEMM ('default' | 'high' | 'highest',
XLA's menu). On the card a float32 product runs as: 'highest' (and None)
full fp32 with TF32 off; 'high' TF32 tensor cores; 'default' bf16 inputs
with fp32 accumulation. Float64 products are always float64.

`cmatmul` carries the same menu to complex operands by running each as
real GEMMs on the (re, im) parts (torch has no bf16 complex type).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _tf32(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str | None):
    """a @ b at `precision` (float32 only; other dtypes run as they are)."""
    if a.dtype != torch.float32:
        return a @ b
    if precision == "default":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(a.dtype)
    with _tf32(precision == "high"):
        return a @ b


def cmatmul(a: torch.Tensor, b: torch.Tensor, precision: str | None):
    """a @ b (torch.matmul broadcasting) where either side may be complex,
    as real `matmul`s on the parts: re = ar br - ai bi, im = ar bi + ai br.
    Returns a complex tensor unless both sides are real."""
    if not (a.is_complex() or b.is_complex()):
        return matmul(a, b, precision)
    mm = lambda x, y: matmul(x, y, precision)
    ar, ai = (a.real, a.imag) if a.is_complex() else (a, None)
    br, bi = (b.real, b.imag) if b.is_complex() else (b, None)
    re = mm(ar, br)
    if ai is not None and bi is not None:
        re = re - mm(ai, bi)
    if bi is None:
        im = mm(ai, br)
    elif ai is None:
        im = mm(ar, bi)
    else:
        im = mm(ar, bi) + mm(ai, br)
    return torch.complex(re, im)
