// Pressure-solve kernels for Hopper (sm_90a): K1, K2 and K5 of the port.
//
// K2 jacobi_fused        replaces ns_tpu/ops/pallas/poisson_kernels.py
//                        ::jacobi_fused_pallas (direct_fd's nit sweeps).
// K2 jacobi_multiblock   its multi-block form, for grids beyond one block's
//                        shared memory (the JAX package's XLA path there).
// K1 sor_redblack_fused  replaces ::sor_redblack_fused_pallas (chorin_fd's
//                        SOR solved to tolerance, one launch).
// K5 sor_redblack_tiled  replaces ::sor_redblack_tiled_pallas and
//                        ::sor_redblack_tiled_any (SOR beyond one block).
//
// What bounds them on the H100. At the reference sizes (50^2, 51^2) a solve
// is a few hundred dependent sweeps over a 20-40 KB grid: the cost is
// latency (one kernel launch and one host-side gate read per sweep would
// dominate), not bytes or FLOPs. K1 and K2 therefore run the whole solve in
// ONE block that keeps the grid in shared memory, separate the phases with
// __syncthreads, and (K1) evaluate the convergence gate with a block
// max-reduction, so the host sees one launch and no sync per sweep. A grid
// larger than shared memory (1024^2) is bandwidth-bound on the L2/HBM
// traffic of each colour half-sweep; K5 runs every half-sweep as a grid of
// blocks over the whole field and reads the gate once per k sweeps through
// an atomic max, so the host syncs once per k sweeps. The multi-block
// Jacobi is bandwidth-bound the same way: each sweep is one grid launch over
// the field into the other buffer of a ping-pong pair (the interior reads
// only old values), then one single-block launch writes the BC edges in
// list order, each edge its own __syncthreads phase (a Neumann edge reads
// the freshly swept inner row, which other blocks wrote). No host sync.

#include "common.cuh"

namespace ns {

// ---------------------------------------------------------------------------
// K2: nit Jacobi sweeps, each followed by the p BC edge writes in list order.
// Ping-pong pair in shared memory (the interior update reads only old
// values); b is read from global memory (read-only, cached). Each BC is its
// own phase behind a __syncthreads, so a Neumann edge reads the freshly
// updated inner row and later BCs overwrite earlier ones at the corners.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(1024)
jacobi_fused_kernel(const T* __restrict__ p_in, const T* __restrict__ b,
                    T* __restrict__ p_out, int nx, int ny, int n_iter, T dx2,
                    T dy2, T denom, T cb, BCList bcs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = nx * ny;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) cur[k] = p_in[k];
  __syncthreads();
  for (int s = 0; s < n_iter; ++s) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int i = k / ny, j = k - i * ny;
      if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) {
        nxt[k] = ((cur[k + 1] + cur[k - 1]) * dy2 +
                  (cur[k + ny] + cur[k - ny]) * dx2) / denom - cb * b[k];
      } else {
        nxt[k] = cur[k];
      }
    }
    __syncthreads();
    for (int q = 0; q < bcs.n; ++q) {
      apply_bc_edge(nxt, nx, ny, bcs.kind[q], bcs.side[q], T(bcs.term[q]),
                    threadIdx.x, blockDim.x);
      __syncthreads();
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) p_out[k] = cur[k];
}

// ---------------------------------------------------------------------------
// K1: red-black SOR to tolerance in one block. p and rhs_c live in shared
// memory; each colour's half-sweep updates in place (a red cell reads only
// black neighbours and itself, and vice versa). Every interior cell changes
// exactly once per sweep, so each thread's max |new - old| over its cells,
// reduced over the block, is the twin's max|p_new - p|. Gate: err=1, it=1,
// loop while err > tol and it < max_iter.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(1024)
sor_redblack_fused_kernel(const T* __restrict__ p_in,
                          const T* __restrict__ rhs, T* __restrict__ p_out,
                          int nx, int ny, T dx2, T dy2, T denom, T beta, T tol,
                          int max_iter) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ U scratch[32];
  __shared__ U result;
  const int n = nx * ny;
  T* p = reinterpret_cast<T*>(smem);
  T* c = p + n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    p[k] = p_in[k];
    c[k] = rhs[k];
  }
  __syncthreads();
  const T omb = T(1) - beta;
  T err = T(1);
  int it = 1;
  while (err > tol && it < max_iter) {
    U dmax = 0;
    for (int color = 0; color < 2; ++color) {
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int i = k / ny, j = k - i * ny;
        if (i < 1 || i > nx - 2 || j < 1 || j > ny - 2 ||
            ((i + j) & 1) != color)
          continue;
        const T old = p[k];
        const T t = dy2 * (p[k + ny] + p[k - ny]) +
                    dx2 * (p[k + 1] + p[k - 1]) - c[k];
        const T nw = beta * t / denom + omb * old;
        p[k] = nw;
        const U d = Bits<T>::of_abs(nw - old);
        dmax = d > dmax ? d : dmax;
      }
      __syncthreads();
    }
    err = Bits<T>::value(block_max(dmax, scratch, &result));
    ++it;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) p_out[k] = p[k];
}

// ---------------------------------------------------------------------------
// K5: one colour half-sweep of red-black SOR over the whole grid, one
// thread per cell of that colour (column j = 2*jc + ((i + color) & 1)).
// Cells of one colour read only the other colour, so the in-place update is
// race-free. Bounds checks on the logical grid stand in for the TPU
// kernel's pad-and-mask, so any shape works (odd 1025^2 included). When
// `err` is given (the last sweep of a group), |dp| is max-reduced per warp
// and folded into *err with one atomicMax on the bit pattern.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
sor_color_kernel(T* __restrict__ p, const T* __restrict__ rhs, int nx, int ny,
                 T dx2, T dy2, T denom, T beta, int color,
                 typename Bits<T>::U* __restrict__ err) {
  using U = typename Bits<T>::U;
  const int jc = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = 2 * jc + ((i + color) & 1);
  U d = 0;
  if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) {
    const int k = i * ny + j;
    const T old = p[k];
    const T t = dy2 * (p[k + ny] + p[k - ny]) + dx2 * (p[k + 1] + p[k - 1]) -
                rhs[k];
    const T nw = beta * t / denom + (T(1) - beta) * old;
    p[k] = nw;
    d = Bits<T>::of_abs(nw - old);
  }
  if (err != nullptr) {
    d = warp_max(d);
    if ((threadIdx.x & 31) == 0 && d != U(0)) atomicMax(err, d);
  }
}

// ---------------------------------------------------------------------------
// K2, multi-block form: one Jacobi sweep over the whole grid, one thread per
// cell, cur -> nxt (boundary cells copied). The BC edges follow in
// bc_edges_kernel.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
jacobi_sweep_kernel(const T* __restrict__ cur, const T* __restrict__ b,
                    T* __restrict__ nxt, int nx, int ny, T dx2, T dy2, T denom,
                    T cb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t k = static_cast<size_t>(i) * ny + j;
  if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) {
    nxt[k] = ((cur[k + 1] + cur[k - 1]) * dy2 +
              (cur[k + ny] + cur[k - ny]) * dx2) / denom - cb * b[k];
  } else {
    nxt[k] = cur[k];
  }
}

// The BC list's edge writes in list order, one block, each edge a phase.
template <typename T>
__global__ void __launch_bounds__(1024)
bc_edges_kernel(T* __restrict__ a, int nx, int ny, BCList bcs) {
  for (int q = 0; q < bcs.n; ++q) {
    apply_bc_edge(a, nx, ny, bcs.kind[q], bcs.side[q], T(bcs.term[q]),
                  threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

template <typename T>
int jacobi_fused(const void* p, const void* b, void* out, int nx, int ny,
                 int n_iter, double dx2, double dy2, double denom, double cb,
                 int n_bc, const double* bc_spec, void* stream) {
  BCList bcs;
  cudaError_t e = make_bcs(n_bc, bc_spec, &bcs);
  if (e != cudaSuccess) return e;
  const size_t smem = 2 * static_cast<size_t>(nx) * ny * sizeof(T);
  e = allow_smem(jacobi_fused_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  jacobi_fused_kernel<T><<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(b), static_cast<T*>(out),
      nx, ny, n_iter, T(dx2), T(dy2), T(denom), T(cb), bcs);
  return cudaGetLastError();
}

// n_iter sweeps alternate between `out` and `scratch`, starting with the
// one that makes the last sweep land in `out`; `p` is only read.
template <typename T>
int jacobi_multiblock(const void* p, const void* b, void* out, void* scratch,
                      int nx, int ny, int n_iter, double dx2, double dy2,
                      double denom, double cb, int n_bc, const double* bc_spec,
                      void* stream) {
  BCList bcs;
  cudaError_t e = make_bcs(n_bc, bc_spec, &bcs);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_iter <= 0)
    return cudaMemcpyAsync(out, p, static_cast<size_t>(nx) * ny * sizeof(T),
                           cudaMemcpyDeviceToDevice, s);
  T* bufs[2] = {static_cast<T*>(out), static_cast<T*>(scratch)};
  int w = n_iter % 2 == 1 ? 0 : 1;
  const T* cur = static_cast<const T*>(p);
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y);
  for (int it = 0; it < n_iter; ++it) {
    T* nxt = bufs[w];
    jacobi_sweep_kernel<T><<<grid, block, 0, s>>>(
        cur, static_cast<const T*>(b), nxt, nx, ny, T(dx2), T(dy2), T(denom),
        T(cb));
    bc_edges_kernel<T><<<1, 1024, 0, s>>>(nxt, nx, ny, bcs);
    cur = nxt;
    w ^= 1;
  }
  return cudaGetLastError();
}

template <typename T>
int sor_redblack_fused(const void* p, const void* rhs, void* out, int nx,
                       int ny, double dx2, double dy2, double denom,
                       double beta, double tol, int max_iter, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(nx) * ny * sizeof(T);
  cudaError_t e = allow_smem(sor_redblack_fused_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  sor_redblack_fused_kernel<T>
      <<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(p), static_cast<const T*>(rhs),
          static_cast<T*>(out), nx, ny, T(dx2), T(dy2), T(denom), T(beta),
          T(tol), max_iter);
  return cudaGetLastError();
}

template <typename T>
int sor_redblack_tiled_group(void* p, const void* rhs, void* err, int nx,
                             int ny, double dx2, double dy2, double denom,
                             double beta, int k, void* stream) {
  using U = typename Bits<T>::U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(U), s);
  if (e != cudaSuccess) return e;
  const dim3 block(32, 8);
  const dim3 grid((ny / 2 + 1 + block.x - 1) / block.x,
                  (nx + block.y - 1) / block.y);
  for (int sweep = 0; sweep < k; ++sweep) {
    U* e_out = sweep == k - 1 ? static_cast<U*>(err) : nullptr;
    for (int color = 0; color < 2; ++color)
      sor_color_kernel<T><<<grid, block, 0, s>>>(
          static_cast<T*>(p), static_cast<const T*>(rhs), nx, ny, T(dx2),
          T(dy2), T(denom), T(beta), color, e_out);
  }
  return cudaGetLastError();
}

}  // namespace ns

extern "C" {

const char* ns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define NS_JACOBI(SUFFIX, T)                                                  \
  int ns_jacobi_fused_##SUFFIX(const void* p, const void* b, void* out,      \
                               int nx, int ny, int n_iter, double dx2,       \
                               double dy2, double denom, double cb, int n_bc, \
                               const double* bc_spec, void* stream) {        \
    return ns::jacobi_fused<T>(p, b, out, nx, ny, n_iter, dx2, dy2, denom,   \
                               cb, n_bc, bc_spec, stream);                   \
  }
NS_JACOBI(f32, float)
NS_JACOBI(f64, double)

#define NS_JACOBI_MB(SUFFIX, T)                                               \
  int ns_jacobi_multiblock_##SUFFIX(                                          \
      const void* p, const void* b, void* out, void* scratch, int nx, int ny, \
      int n_iter, double dx2, double dy2, double denom, double cb, int n_bc,  \
      const double* bc_spec, void* stream) {                                  \
    return ns::jacobi_multiblock<T>(p, b, out, scratch, nx, ny, n_iter, dx2,  \
                                    dy2, denom, cb, n_bc, bc_spec, stream);   \
  }
NS_JACOBI_MB(f32, float)
NS_JACOBI_MB(f64, double)

#define NS_SOR_FUSED(SUFFIX, T)                                               \
  int ns_sor_redblack_fused_##SUFFIX(const void* p, const void* rhs,         \
                                     void* out, int nx, int ny, double dx2,  \
                                     double dy2, double denom, double beta,  \
                                     double tol, int max_iter,               \
                                     void* stream) {                         \
    return ns::sor_redblack_fused<T>(p, rhs, out, nx, ny, dx2, dy2, denom,   \
                                     beta, tol, max_iter, stream);           \
  }
NS_SOR_FUSED(f32, float)
NS_SOR_FUSED(f64, double)

#define NS_SOR_TILED(SUFFIX, T)                                               \
  int ns_sor_redblack_tiled_group_##SUFFIX(                                  \
      void* p, const void* rhs, void* err, int nx, int ny, double dx2,       \
      double dy2, double denom, double beta, int k, void* stream) {          \
    return ns::sor_redblack_tiled_group<T>(p, rhs, err, nx, ny, dx2, dy2,    \
                                           denom, beta, k, stream);          \
  }
NS_SOR_TILED(f32, float)
NS_SOR_TILED(f64, double)

}  // extern "C"
