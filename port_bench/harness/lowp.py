"""Rounding to a lower precision, for the controls: a value as a GEMM of
that precision receives it, returned in the input's dtype.

  'tf32': float32 with a 10-bit mantissa, rounded to nearest (ties away,
          as the tensor cores' cvt.rna.tf32.f32);
  'bf16': bfloat16, rounded to nearest even;
  'fp8':  float8 e4m3 with one scale for the whole tensor (its largest
          magnitude maps to 448), as a per-tensor-scaled fp8 GEMM takes it.

A complex tensor has its real and imaginary parts rounded alike.
"""

from __future__ import annotations

import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().max()
    if not bool(amax > 0):
        return x
    scale = 448.0 / amax
    q = (x * scale).to(torch.float32).to(torch.float8_e4m3fn)
    return q.to(x.dtype) / scale


_REAL = {"tf32": _tf32, "bf16": _bf16, "fp8": _fp8}


def rounder(kind: str | None):
    """The rounding function of `kind`, or the identity for None."""
    if kind is None:
        return lambda x: x
    real = _REAL[kind]

    def rd(x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            if kind == "fp8":  # one scale for both parts
                parts = torch.view_as_real(x)
                return torch.view_as_complex(real(parts).contiguous())
            return torch.complex(real(x.real), real(x.imag))
        return real(x)

    return rd
