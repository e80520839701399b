// Helpers shared by the hand-written Hopper kernels of ns_tpu_torch.
//
// Built with nvcc into one shared library with a plain C interface
// (ns_tpu_torch/ops/kernels/_build.py); every entry point launches on the
// stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ns {

constexpr int kMaxBCs = 8;

// A boundary-condition list as the kernels see it (ns_tpu_torch.core.bc).
// kind: 0 Dirichlet, 1 Neumann. side: 0 left (row 0), 1 right (row nx-1),
// 2 bottom (col 0), 3 top (col ny-1). term: the Dirichlet value, or the
// signed Neumann offset added to the inner neighbour (BC.edge_term, formed
// in double on the host). Passed to the kernel by value.
struct BCList {
  int n;
  int kind[kMaxBCs];
  int side[kMaxBCs];
  double term[kMaxBCs];
};

// Host: unpack the wrapper's flat [kind, side, term] * n spec.
inline cudaError_t make_bcs(int n, const double* spec, BCList* out) {
  if (n < 0 || n > kMaxBCs) return cudaErrorInvalidValue;
  out->n = n;
  for (int b = 0; b < n; ++b) {
    out->kind[b] = static_cast<int>(spec[3 * b]);
    out->side[b] = static_cast<int>(spec[3 * b + 1]);
    out->term[b] = spec[3 * b + 2];
  }
  return cudaSuccess;
}

// One BC's edge write on a row-major (nx, ny) field, shared out over the
// threads tid = 0..nthr-1 of one block. A Neumann edge reads its inner
// neighbour row/column, which no thread writes in the same phase.
template <typename T>
__device__ __forceinline__ void apply_bc_edge(T* a, int nx, int ny, int kind,
                                              int side, T term, int tid,
                                              int nthr) {
  if (side <= 1) {  // left: row 0 from row 1; right: row nx-1 from row nx-2
    const int row = side == 0 ? 0 : nx - 1;
    const int inner = side == 0 ? 1 : nx - 2;
    for (int j = tid; j < ny; j += nthr)
      a[row * ny + j] = kind == 0 ? term : a[inner * ny + j] + term;
  } else {  // bottom: col 0 from col 1; top: col ny-1 from col ny-2
    const int col = side == 2 ? 0 : ny - 1;
    const int inner = side == 2 ? 1 : ny - 2;
    for (int i = tid; i < nx; i += nthr)
      a[i * ny + col] = kind == 0 ? term : a[i * ny + inner] + term;
  }
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
