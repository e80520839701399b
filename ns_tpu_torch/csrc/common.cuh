// Helpers shared by the hand-written Hopper kernels of ns_tpu_torch.
//
// Built with nvcc into one shared library with a plain C interface
// (ns_tpu_torch/ops/kernels/_build.py); every entry point launches on the
// stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ns {

// The edge plan of a boundary-condition list (ns_tpu_torch.core.bc), built
// on the host by ops/kernels/poisson_kernels.py::k2_edge_plan. After the
// list is applied in order, a non-corner cell of a side holds what the
// side's last BC writes there: its term (Dirichlet) or the inner neighbour
// next to it plus its term (Neumann); no other BC touches it. A corner holds
// what its last writer among its two sides' BCs leaves there, read from the
// edge cell next to it as the list left that cell. Per side (0 left = row
// 0, 1 right = row nx-1, 2 bottom = col 0, 3 top = col ny-1): the kind of
// its last BC (-1 none, 0 Dirichlet, 1 Neumann) and that BC's term (the
// Dirichlet value, or the signed Neumann offset, BC.edge_term, formed in
// double); per corner ((0,0), (0,ny-1), (nx-1,0), (nx-1,ny-1)) the side
// whose BC writes it last, or -1. Passed to a kernel by value; kernels
// index it with constant indices only (a runtime index would put it on the
// stack).
struct EdgePlan {
  int kind[4];
  int corner[4];
  double term[4];
};

// Host: unpack the wrapper's 12 doubles kind[4], corner[4], term[4].
inline cudaError_t make_plan(const double* spec, EdgePlan* plan) {
  for (int s = 0; s < 4; ++s) {
    plan->kind[s] = static_cast<int>(spec[s]);
    plan->corner[s] = static_cast<int>(spec[4 + s]);
    plan->term[s] = spec[8 + s];
    if (plan->kind[s] < -1 || plan->kind[s] > 1 || plan->corner[s] < -1 ||
        plan->corner[s] > 3)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Arithmetic with its rounding pinned: nvcc neither contracts these into an
// FMA nor reorders them, so one expression rounds alike wherever it is
// inlined.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
// The value unchanged, hidden from the optimizer.
__device__ __forceinline__ float opaque(float x) {
  asm("" : "+f"(x));
  return x;
}
__device__ __forceinline__ double opaque(double x) {
  asm("" : "+d"(x));
  return x;
}

// x / d for a finite, nonzero d, rounded as IEEE division. The division's
// range check sends a zero dividend down its slow path, which made K2mb
// and K3 1.6-2.5x slower on a field at rest (a cavity's early steps). So a
// zero x divides d instead (`opaque`: else nvcc, seeing the quotient
// unused, divides x after all), and the quotient's zero, sign included, is
// x * d. No branch: a warp of mixed cells runs one path.
template <typename T>
__device__ __forceinline__ T div_nz(T x, T d) {
  const bool zero = x == T(0);
  const T q = opaque(zero ? d : x) / d;
  return zero ? x * d : q;
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// A non-negative float orders like its bit pattern read as an unsigned
// integer, so max-reductions of |dp| run on the bits: warp shuffles and
// atomicMax work on integers, and a NaN (sign cleared by fabs) stays the
// largest value and stops the gate, as a NaN max does in the twin.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = unsigned int;
  static constexpr U kInf = 0x7f800000u;
  static __device__ __forceinline__ U of_abs(float x) {
    return __float_as_uint(fabsf(x));
  }
  static __device__ __forceinline__ float value(U u) {
    return __uint_as_float(u);
  }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kInf = 0x7ff0000000000000ull;
  static __device__ __forceinline__ U of_abs(double x) {
    return static_cast<U>(__double_as_longlong(fabs(x)));
  }
  static __device__ __forceinline__ double value(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
  for (int o = 16; o > 0; o >>= 1) {
    const U w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Max over the whole block (blockDim.x a multiple of 32), returned to every
// thread. scratch holds 32 entries; result one.
template <typename U>
__device__ __forceinline__ U block_max(U v, U* scratch, U* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? scratch[lane] : U(0);
    v = warp_max(v);
    if (lane == 0) *result = v;
  }
  __syncthreads();
  return *result;
}

// Raise the dynamic shared-memory cap of `kernel` where `bytes` needs it
// (above 48 KB, up to the 227 KB a Hopper block may opt into).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ns
