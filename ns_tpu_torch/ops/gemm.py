"""Matrix products at a configured precision (plain torch, cuBLAS on CUDA).

The JAX package names a precision per GEMM ('default' | 'high' | 'highest',
XLA's menu). On the card a float32 product runs as:
  'highest', 'high' (and None): full fp32 with TF32 off. The TPU's HIGH is
      bf16x3 (~5e-6 of max|out|); fp32 is more accurate (~2e-7), as the
      JAX kernels' `_prec` also promotes 'high' to HIGHEST, and on the H100
      it ran the plain 256^3 'high' step loop faster than a bf16x3 form of
      three bf16 GEMMs (82 against 50 steps/s; PERF.md, measured with
      tools/torch_gemm_high_forms.py). TF32 (10-bit inputs, ~3.5e-4) is
      looser than the reference's HIGH and is never enabled;
  'default': the TPU's DEFAULT with an fp32 result: the inputs are rounded
      to bf16 (round to nearest even), and the product of the rounded
      inputs is taken and returned in fp32, with no rounding of the output
      (`torch.mm`/`torch.bmm` with `out_dtype=float32`: bf16 tensor cores,
      fp32 accumulation, no bf16 output).
On the CPU, which has no bf16 GEMM with an fp32 output, 'default' is an
fp32 GEMM of the bf16-rounded inputs, the same maths summed in another
order. Float64 products are always float64.

Gradients follow the same rule. Autograd runs the backward products after
the forward call has returned, so neither the TF32 switch of the forward
nor its bf16 rounding would reach them: a float32 product that needs a
gradient runs as `_Product`, whose backward computes g @ b^H and a^H @ g
by the forward's own product. At 'default' that is the transpose of a
TPU DEFAULT dot, another DEFAULT dot: bf16-rounded operands (the
cotangent too), fp32 sums and result.

`cmatmul` carries the same menu to complex operands by running each as
real GEMMs on the (re, im) parts (torch has no bf16 complex type).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the products inside, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (torch.matmul broadcasting, both at least 2D) for bf16 a, b on
    CUDA, accumulated and returned in fp32."""
    if a.dim() == 2 and b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (m, k), n = a.shape[-2:], b.shape[-1]
    # a 2D side broadcasts with a zero batch stride (expand, no copy)
    a3 = a.expand(*batch, m, k).reshape(-1, m, k)
    b3 = b.expand(*batch, k, n).reshape(-1, k, n)
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(*batch, m, n)


def _fp32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _no_tf32():
        return a @ b


def _default_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return _bf16_mm_f32(a, b)
    return a.float() @ b.float()


# a layer's weight gradient sums x_b @ y_b over the batch b, each a small
# (m, n) tile over a long contraction K (the grid's points), one block of
# the card a tile. Under _CUT_BATCH samples, K is cut into pieces of
# _PIECE (halving while it divides), one batched product over all the
# pieces, summed after; from _CUT_BATCH on, the batch fills the card
# uncut, and the copies a cut takes cost more than it saves. On the H100
# (PERF.md, tools/torch_weight_grad.py): cut, fno3d_a's batch of 4 over
# 64^3 ran 0.29 ms a bypass gradient (8.66 uncut) and a batch of 32 2.09
# (8.16); uncut, fno_w's 99 windows over 128^2 ran 0.62 (1.16 cut), and
# 199 windows over 64^2 0.26 (0.63 cut).
_CUT_BATCH, _PIECE = 64, 1024


def _batch_contract(product, x: torch.Tensor, y: torch.Tensor):
    """The sum over the batch axes of x @ y, x (..., m, K), y (..., K, n):
    (m, n)."""
    m, K = x.shape[-2:]
    nb, c = x.numel() // (m * K), 1
    while (nb < _CUT_BATCH and K % (2 * c) == 0
           and K // (2 * c) >= _PIECE):
        c *= 2
    L = K // c
    x4 = x.reshape(nb, m, c, L).transpose(1, 2)              # (B, c, m, L)
    y4 = y.reshape(nb, c, L, y.shape[-1])                    # (B, c, L, n)
    return product(x4, y4).sum((0, 1))


class _Product(torch.autograd.Function):
    """a @ b (both at least 2D) by `product`, whose backward runs the
    transposed products by the same `product`; a broadcast operand's
    gradient is summed over the batch axes it was broadcast along."""

    @staticmethod
    def forward(ctx, a, b, product):
        ctx.save_for_backward(a, b)
        ctx.product = product
        return product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        product = ctx.product
        ga = gb = None
        if ctx.needs_input_grad[0]:
            if a.dim() == 2 and b.dim() > 2:  # a layer's weight gradient
                ga = _batch_contract(product, g, b.mH)
            else:
                ga = product(g, b.mH).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2 and a.dim() > 2:  # one product over the batch
                k, n = a.shape[-1], g.shape[-1]
                gb = product(a.reshape(-1, k).mH, g.reshape(-1, n))
            else:
                gb = product(a.mH, g).sum_to_size(b.shape)
        return ga, gb, None


def _apply(product, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
            and a.dim() >= 2 and b.dim() >= 2):
        return _Product.apply(a, b, product)
    return product(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str | None):
    """a @ b at `precision` (float32 and complex64, whose products also run
    with TF32 off; other dtypes run as they are).
    At 'default' a bfloat16 operand against a float32 one is a constant
    table rounded once, which the rounding here leaves as it is. A complex
    operand is never rounded (its imaginary part would be lost)."""
    table = {a.dtype, b.dtype} == {torch.float32, torch.bfloat16}
    if (precision == "default" and (a.dtype == torch.float32 or table)
            and not (a.is_complex() or b.is_complex())):
        return _apply(_default_product, a, b)
    if a.dtype not in (torch.float32, torch.complex64):
        return a @ b
    return _apply(_fp32_product, a, b)


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


def each_member(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for one (m, n) operand; for a (B, m, n) batch of members, fn on
    each member in turn, stacked. The FD ensemble's GEMM stages (the ADI
    sweeps, the dst, Helmholtz and mixed-BC solves) run so, to keep each
    member its single rollout's bits: a batched product (cuBLAS's bmm, a
    CPU library's batched GEMM) picks its kernel by the batch's shapes, and
    a member's slice of a batch may sit at an alignment that steers the
    library to another kernel, so each member runs on a copy of its own,
    laid out as a single call's operand is."""
    if x.dim() == 2:
        return fn(x)
    return torch.stack([fn(m.clone()) for m in x])
