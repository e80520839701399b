// Pressure-solve kernels for Hopper (sm_90a): K1, K2, K4 and K5 of the port.
//
// K2 jacobi_fused        replaces ns_tpu/ops/pallas/poisson_kernels.py
//                        ::jacobi_fused_pallas (direct_fd's nit sweeps).
// K2 jacobi_multiblock   its multi-block form, for grids beyond one block's
//                        shared memory (the JAX package's XLA path there).
// K1 sor_redblack_fused  replaces ::sor_redblack_fused_pallas (chorin_fd's
//                        SOR solved to tolerance, one launch).
// K4 sor_redblack_packed replaces ::sor_redblack_packed_tiled_pallas (SOR
//                        beyond one block on packed colour planes, the
//                        branch chorin_fd takes for nx%128 == 0, ny%256 == 0).
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
// an atomic max, so the host syncs once per k sweeps. That costs 2k
// launches per gate group, and each launch reads every column to update
// half of them. K4 runs the whole group in ONE launch: each block loads a
// 2D tile of the packed colour planes (R, B of shape (nx, ny/2), so a
// colour update touches only its own cells) with the halo that k sweeps'
// dependency cone needs into shared memory, runs the k sweeps there with
// __syncthreads between colour half-sweeps, and writes its own cells into
// the other buffers of a ping-pong pair. The TPU strip (160 x 512 packed
// cells x 4 planes at 1024^2, 1.3 MB) cannot fit a block, so the tile is
// 64 x 64 own cells in both directions; rhs stays in global memory,
// read-only (in shared memory it measured no faster). Halo blocks recompute
// their neighbours' cells, (96 x 80) / (64 x 64) = 1.9x the useful work at
// k=8, to trade 2k launches for one. A group is then bound by instructions
// per cell update (bounds checks, the IEEE division, the halo recompute),
// not by bytes: 1024 threads a block ran it 1.6x faster than 512.
// The multi-block
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

// ---------------------------------------------------------------------------
// K4: one gate group (k full red-black sweeps) on the packed colour planes,
// one block per tile of tile_rows x tile_cols own packed cells. The block's
// working tile adds H = 2k rows and k packed columns on each side: a colour
// half-sweep reads only the four nearest cells, so a cell that could not be
// updated from in-tile values (the tile's edge) taints at most the cells one
// unpacked step further in per half-sweep; after 2k half-sweeps the own
// cells, 2k+1 steps in, are exact. Working cells outside the grid are never
// loaded or read (interior cells read only cells of the grid). Neighbours:
// up/down are the other colour at the same packed column; left/right are
// other[jc] and other[jc + s], where s = +1 for a cell at odd global j
// (2jc+1: neighbours 2jc and 2jc+2) and -1 at even j. The update is written
// in the TPU kernel's expression order. Reads the (Rin, Bin) snapshot, writes
// (Rout, Bout): blocks whose halos overlap never see each other's writes.
// The last sweep's max |new - old| over own interior cells is max-reduced
// per warp and folded into *err with one atomicMax on the bit pattern.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(1024)
sor_packed_group_kernel(const T* __restrict__ Rin, const T* __restrict__ Bin,
                        const T* __restrict__ cR, const T* __restrict__ cB,
                        T* __restrict__ Rout, T* __restrict__ Bout, int nx,
                        int ny, int tile_rows, int tile_cols, int k, T dx2,
                        T dy2, T denom, T beta,
                        typename Bits<T>::U* __restrict__ err) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ny2 = ny / 2;
  const int hr = 2 * k, hc = k;
  const int wr = tile_rows + 2 * hr, wc = tile_cols + 2 * hc;
  T* sR = reinterpret_cast<T*>(smem);
  T* sB = sR + wr * wc;
  const int r0 = blockIdx.y * tile_rows - hr;  // global row of working row 0
  const int c0 = blockIdx.x * tile_cols - hc;  // global packed column of col 0
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int r = ty; r < wr; r += nwarps) {
    const int gi = r0 + r;
    if (gi < 0 || gi >= nx) continue;
    for (int c = tx; c < wc; c += 32) {
      const int gc = c0 + c;
      if (gc < 0 || gc >= ny2) continue;
      const size_t g = static_cast<size_t>(gi) * ny2 + gc;
      sR[r * wc + c] = Rin[g];
      sB[r * wc + c] = Bin[g];
    }
  }
  __syncthreads();

  const T omb = T(1) - beta;
  U dmax = 0;
  for (int sweep = 0; sweep < k; ++sweep) {
    const bool last = sweep == k - 1;
    for (int color = 0; color < 2; ++color) {
      T* self = color == 0 ? sR : sB;
      const T* other = color == 0 ? sB : sR;
      const T* rhs = color == 0 ? cR : cB;
      for (int r = ty; r < wr; r += nwarps) {
        const int gi = r0 + r;
        if (r < 1 || r > wr - 2 || gi < 1 || gi > nx - 2) continue;
        // j parity of this colour's cells in row gi: red (i+j) even, black odd
        const int jpar = (gi + color) & 1;
        const int shift = jpar ? 1 : -1;
        const bool own_row = r >= hr && r < hr + tile_rows;
        for (int c = tx; c < wc; c += 32) {
          const int gc = c0 + c;
          const int j = 2 * gc + jpar;
          const int cs = c + shift;
          if (gc < 0 || gc >= ny2 || j < 1 || j > ny - 2 || cs < 0 || cs >= wc)
            continue;
          const int q = r * wc + c;
          const T old = self[q];
          const T t = dy2 * (other[q + wc] + other[q - wc]) +
                      dx2 * (other[q] + other[r * wc + cs]) -
                      rhs[static_cast<size_t>(gi) * ny2 + gc];
          const T nw = beta * t / denom + omb * old;
          self[q] = nw;
          if (last && own_row && c >= hc && c < hc + tile_cols) {
            const U d = Bits<T>::of_abs(nw - old);
            dmax = d > dmax ? d : dmax;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int r = hr + ty; r < hr + tile_rows; r += nwarps) {
    const int gi = r0 + r;
    if (gi < 0 || gi >= nx) continue;
    for (int c = hc + tx; c < hc + tile_cols; c += 32) {
      const int gc = c0 + c;
      if (gc < 0 || gc >= ny2) continue;
      const size_t g = static_cast<size_t>(gi) * ny2 + gc;
      Rout[g] = sR[r * wc + c];
      Bout[g] = sB[r * wc + c];
    }
  }
  dmax = warp_max(dmax);
  if (tx == 0 && dmax != U(0)) atomicMax(err, dmax);
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

// One K4 gate group: k sweeps of the packed planes (R, B) -> (Rout, Bout)
// in one launch, the last sweep's max|dp| left in *err.
template <typename T>
int sor_redblack_packed_group(const void* R, const void* B, const void* cR,
                              const void* cB, void* Rout, void* Bout,
                              void* err, int nx, int ny, int tile_rows,
                              int tile_cols, double dx2, double dy2,
                              double denom, double beta, int k, void* stream) {
  using U = typename Bits<T>::U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || tile_rows < 1 || tile_cols < 1 || ny % 2)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(U), s);
  if (e != cudaSuccess) return e;
  const size_t smem = 2 * static_cast<size_t>(tile_rows + 4 * k) *
                      (tile_cols + 2 * k) * sizeof(T);
  e = allow_smem(sor_packed_group_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ny / 2 + tile_cols - 1) / tile_cols,
                  (nx + tile_rows - 1) / tile_rows);
  sor_packed_group_kernel<T><<<grid, 1024, smem, s>>>(
      static_cast<const T*>(R), static_cast<const T*>(B),
      static_cast<const T*>(cR), static_cast<const T*>(cB),
      static_cast<T*>(Rout), static_cast<T*>(Bout), nx, ny, tile_rows,
      tile_cols, k, T(dx2), T(dy2), T(denom), T(beta), static_cast<U*>(err));
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

#define NS_SOR_PACKED(SUFFIX, T)                                              \
  int ns_sor_redblack_packed_group_##SUFFIX(                                 \
      const void* R, const void* B, const void* cR, const void* cB,          \
      void* Rout, void* Bout, void* err, int nx, int ny, int tile_rows,      \
      int tile_cols, double dx2, double dy2, double denom, double beta,      \
      int k, void* stream) {                                                 \
    return ns::sor_redblack_packed_group<T>(R, B, cR, cB, Rout, Bout, err,   \
                                            nx, ny, tile_rows, tile_cols,    \
                                            dx2, dy2, denom, beta, k,        \
                                            stream);                         \
  }
NS_SOR_PACKED(f32, float)
NS_SOR_PACKED(f64, double)

}  // extern "C"
