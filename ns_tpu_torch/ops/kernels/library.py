"""The hand-written kernels as operators of one `torch.library` namespace,
`ns_tpu`: `torch.ops.ns_tpu.<route>`, one operator for each route that
`WRAPPERS` names (K1-K8 and K2's multi-block form).

Each operator has a schema of tensors, ints, floats, bools, `float[]` and
`str`, and three implementations:
- CUDA: the route's kernel (`_*_cuda` in its wrapper's module: the input
  checks, the library built at the first launch, the launch, the error
  check after it and the wrapper's `launches` / `calls` counters);
- CPU: the route's plain twin (`_*_cpu`, or the twin itself);
- fake: empty outputs of the shape, dtype and device the kernel gives,
  reading no data.

So the dispatcher, not the wrapper, picks kernel or twin by the tensors'
device, and `torch.export`, FakeTensor tracing and CUDA graphs see each
operator as one node: a host read inside an implementation (the gate of
K4's and K5's group routes, the per-sweep gate of K1's twin, the
occupancy queries of the tile plans) is invisible to a trace. Every
output is a new tensor: the schemas declare no alias and no mutated
argument, as the wrappers always returned new tensors, so an exported
program needs no copy around them. A BC list enters as its edge plan
(`poisson_kernels.edge_plan`, 12 numbers), from which the CUDA side
builds the C entry's array (cached on the plan) and the CPU side the BC
list its twin applies (`plan_bcs`); K6-K8 take their DFT tables as
tensors and the precision as a string.

The operators are registered through `torch.library.Library` with
`define`, `impl` and `register_fake`, the low-level form, whose dispatch
costs less a call than the `custom_op` decorator's. Importing this module
(the package's `__init__` does) registers them and builds nothing; it
imports no solver, so a program exported with these operators loads
without `ns_tpu_torch.solvers` (`runtime/engine.py::_load_artifact`).
"""

from __future__ import annotations

import torch

from ns_tpu_torch.ops.kernels import momentum_kernels as mk
from ns_tpu_torch.ops.kernels import poisson_kernels as pk
from ns_tpu_torch.ops.kernels import transform3d_kernels as tk

NAMESPACE = "ns_tpu"

_SOR = ("(Tensor p, Tensor rhs_c, float dx, float dy, float beta, float tol, "
        "int max_iter{}) -> Tensor")
_JACOBI = ("(Tensor p, Tensor b, float dx, float dy, int n_iter, "
           "float[] p_plan) -> Tensor")


def _like_p(p, *_):
    return torch.empty_like(p)


def _momentum_fake(un, vn, *_):
    return torch.empty_like(un), torch.empty_like(vn)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _zy_forward_fake(w, Fz_t, Fy_t, precision):
    return w.new_empty((*w.shape[:-2], Fy_t.shape[0], Fz_t.shape[0]),
                       dtype=_complex_of(w.dtype))


def _yz_inverse_fake(a, Fyi_t, Bz, nz, precision):
    return a.new_empty((*a.shape[:-2], Fyi_t.shape[0], nz),
                       dtype=_real_of(a.dtype))


def _lamb_fake(a6, *_):
    return a6.new_empty((3, *a6.shape[1:]))


# name: (schema less the name, CUDA, CPU, fake)
OPERATORS = {
    "sor_redblack_fused": (_SOR.format(""), pk._sor_redblack_fused_cuda,
                           pk._sor_redblack_fused_cpu, _like_p),
    "jacobi_fused": (_JACOBI, pk._jacobi_fused_cuda, pk._jacobi_cpu,
                     _like_p),
    "jacobi_multiblock": (_JACOBI, pk._jacobi_multiblock_cuda,
                          pk._jacobi_cpu, _like_p),
    "momentum_explicit_fused": (
        "(Tensor un, Tensor vn, Tensor un1, Tensor vn1, float dt, float dx, "
        "float dy, float nu, float[] u_plan, float[] v_plan, "
        "bool quirk_compat) -> (Tensor, Tensor)",
        mk._momentum_cuda, mk._momentum_cpu, _momentum_fake),
    "sor_redblack_packed_multiblock": (
        _SOR.format(", int k"), pk._sor_redblack_packed_multiblock_cuda,
        pk._sor_redblack_packed_multiblock_cpu, _like_p),
    "sor_redblack_multiblock": (
        _SOR.format(", int k"), pk._sor_redblack_multiblock_cuda,
        pk._sor_redblack_multiblock_cpu, _like_p),
    "fused_zy_forward": (
        "(Tensor w, Tensor Fz_t, Tensor Fy_t, str precision) -> Tensor",
        tk._zy_forward_cuda, tk.zy_forward, _zy_forward_fake),
    "fused_yz_inverse": (
        "(Tensor a, Tensor Fyi_t, Tensor Bz, int nz, str precision) "
        "-> Tensor", tk._yz_inverse_cuda, tk.yz_inverse, _yz_inverse_fake),
    "fused_lamb": (
        "(Tensor a6, Tensor Fyi_t, Tensor Bz, Tensor Fz_t, Tensor Fy_t, "
        "int nz, str precision) -> Tensor",
        tk._lamb_cuda, tk.lamb, _lamb_fake),
}

# the registrations live as long as this object
_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_schema, _cuda, _cpu, _fake) in OPERATORS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
