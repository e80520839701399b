// Pressure-solve kernels for Hopper (sm_90a): K1, K2, K4 and K5 of the port.
//
// K2 jacobi_fused        replaces ns_tpu/ops/pallas/poisson_kernels.py
//                        ::jacobi_fused_pallas (direct_fd's nit sweeps).
// K2 jacobi_multiblock   its multi-block form, for grids beyond one block's
//                        shared memory (the JAX package's XLA path there;
//                        one launch a solve where its tiles fit the card).
// K1 sor_redblack_fused  replaces ::sor_redblack_fused_pallas (chorin_fd's
//                        SOR solved to tolerance, one launch).
// K4 sor_redblack_packed replaces ::sor_redblack_packed_tiled_pallas (SOR
//                        beyond one block on packed colour planes, the
//                        branch chorin_fd takes for nx%128 == 0, ny%256 == 0;
//                        one launch a solve where its tiles fit the card).
// K5 sor_redblack_tiled  replaces ::sor_redblack_tiled_pallas and
//                        ::sor_redblack_tiled_any (SOR beyond one block, any
//                        shape: K4's resident kernel where its tiles fit the
//                        card, else colour half-sweep grids).
//
// What bounds them on the H100.
//
// K1 and K2, at the reference sizes (50^2, 51^2): a solve is a few hundred
// dependent sweeps over a 20-40 KB grid, so one launch and no host read
// per solve is the first rule (a launch or a gate read per sweep would
// dominate). Both run the whole solve in ONE block that keeps the grid in
// shared memory. Inside that block K1 is bound by instruction issue: one
// SM issues 4 warp-instructions a cycle, and a sweep is ~2400 cell updates
// of ~40 instructions, a third of them the IEEE division of the TPU
// kernel's expression. So K1 keeps p as packed colour planes, gives each of
// its 1024 threads fixed cells of each colour (their offsets and rhs_c
// found once, before the sweeps), so no lane idles on the other colour and
// no index is divided in the sweep loop, and publishes the gate through the
// colour barriers (two barriers a sweep instead of four). 51^2: 43
// registers, no spill; 1.0 us a sweep. K2 gives its threads fixed
// interior cells the same way and folds the BC list into the sweep as an
// edge plan (the thread that sweeps a cell next to an edge writes the edge
// cell; corners once at the end): one barrier a sweep instead of 1 + the
// number of BCs.
//
// A batch of members (the FD ensemble, which the JAX package runs under
// vmap: Pallas then gives each kernel's grid a member axis) is one launch
// of K1 or K2 with one block a member on blockIdx.x, each at its member's
// base (a member stride apart) with its own cells, plan and, in K1, its
// own gate; at 50^2 and 51^2 a block holds an SM, so up to 132 members run
// at once and larger batches run in waves. A batch of one is the single
// launch.
//
// K4 and K5, beyond one block (1024^2, 1025^2): the TPU kernels reload a
// strip per gate group and their while_loop reads the gate on the device.
// Both keep each block's tile of the packed colour planes (R, B of shape
// (nx, (ny+1)/2): a colour update touches only its own cells; at an odd ny
// one plane's last column in each row lies outside the grid and is never
// read) with the halo that k sweeps' dependency cone needs in shared
// memory. Where the card's shared memory holds every tile at once (one
// block a SM; 1024^2 and 1025^2 in both dtypes), the whole solve is ONE
// cooperative launch: the tiles stay resident, blocks exchange their own
// cells through L2 after each group, meet at a grid barrier and read the
// group's error slot on the device, so no host read and no relaunch. A
// group is then bound by instruction issue on each SM again: the halo's
// recomputed cells (cut to the shrinking dependency cone, 1.4x the own
// cells at k=8 with 64 x 64 tiles) and the division. Grids too large for
// the card keep one launch per group and the host gate: K4 on packed
// tiles, K5 as colour half-sweep grids over the whole field (2k launches a
// group of k sweeps, every column read to update half of them). fp32: 32
// registers, no spill.
//
// K2 beyond one block (direct_fd at 1024^2 and 1025^2: nit=50 sweeps of a
// 4-8 MB field) keeps the same idea on tiles: each block holds its tile of
// p with a halo of k cells (the reach of k Jacobi sweeps) in shared memory
// and runs k sweeps there, each cut to the cells its own cells still depend
// on, with K2's edge plan inside the sweep; then it exchanges its own cells
// through L2 and meets the other blocks at a grid barrier. Where every tile
// fits the card at once (jacobi_resident_plan in poisson_kernels.py) the
// whole solve is one cooperative launch; beyond that, one launch per group
// of k sweeps between two global buffers. nit is fixed: no gate, no host
// read. Each sweep is bound by instruction issue on its SM, as K4's is: the
// IEEE division of a cell update and the halo's recomputed cells.

#include "common.cuh"

namespace ns {

// ---------------------------------------------------------------------------
// K2: nit Jacobi sweeps, each followed by the p BC list in list order, in
// one block. Ping-pong pair in shared memory (the interior update reads
// only old values), both loaded with p so that boundary cells no BC writes
// hold their value in either buffer. The BC list becomes an edge plan
// (poisson_kernels.py::k2_edge_plan builds it on the host): after a sweep,
// a non-corner cell of a side holds what the side's last BC leaves there,
// its term (Dirichlet) or the freshly swept interior cell next to it plus
// its term (Neumann); no other BC touches it. So the thread that sweeps an
// interior cell next to an edge also writes that edge cell, in the same
// phase. A corner holds what its last writer among its two sides' BCs
// leaves there, read from the edge cell next to it as the list left that
// cell, which is that cell's final value. No update reads a corner, so the
// corners are written once, after the last sweep. One barrier a sweep.
// Each of the 1024 threads owns the interior list entries t, t + 1024, ...
// (row-major), their offsets and edge flags found once before the sweeps,
// so the sweep loop has no division; cb * b is rounded on its own, as the
// twin rounds it, into registers (B_REG) or every sweep from global memory.
// ---------------------------------------------------------------------------

// One Jacobi update of cell k of the working array c (row pitch `pitch`),
// in the expression and order of the twin (ops/poisson.py::jacobi):
// ((c[k+1] + c[k-1]) * dy2 + (c[k+pitch] + c[k-pitch]) * dx2) / denom - cb,
// every operation rounded on its own, so K2 and K2's multi-block form give
// the same bits on every grid both take (the division by div_nz).
template <typename T>
__device__ __forceinline__ T jacobi_cell(const T* __restrict__ c, int k,
                                         int pitch, T dx2, T dy2, T denom,
                                         T cbb) {
  return sub_rn(div_nz(add_rn(mul_rn(add_rn(c[k + 1], c[k - 1]), dy2),
                              mul_rn(add_rn(c[k + pitch], c[k - pitch]),
                                     dx2)),
                       denom),
                cbb);
}

// MAXC: interior list entries a thread owns (at most). Each entry's code is
// its flat offset (15 bits: nx * ny < 32768 for every grid that fits) and,
// above it, a flag per side whose edge cell next to it this thread writes.
// Block m solves member m of a batch, `stride` elements after member m - 1
// (the batched form of the TPU kernel under vmap, whose grid gains a member
// axis): the member's base moves the three pointers, the codes and the
// plan are every member's own.
template <typename T, int MAXC, bool B_REG>
__global__ void __launch_bounds__(1024)
jacobi_fused_kernel(const T* __restrict__ p_in, const T* __restrict__ b,
                    T* __restrict__ p_out, int nx, int ny, int n_iter, T dx2,
                    T dy2, T denom, T cb, EdgePlan plan, long long stride) {
  constexpr int NT = 1024;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long member = static_cast<long long>(blockIdx.x) * stride;
  p_in += member;
  b += member;
  p_out += member;
  const int tid = threadIdx.x, n = nx * ny, w = ny - 2;
  const int count = (nx - 2) * w;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + n;
  for (int k = tid; k < n; k += NT) {
    const T v = p_in[k];
    cur[k] = v;
    nxt[k] = v;
  }
  unsigned code[MAXC];
  T cbb[MAXC];
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    const int idx = m * NT + tid;
    code[m] = 0;
    cbb[m] = T(0);
    if (idx < count) {
      const int i = 1 + idx / w, j = 1 + idx - (i - 1) * w;
      const int k = i * ny + j;
      const unsigned f = (i == 1 && plan.kind[0] >= 0 ? 1u : 0u) |
                         (i == nx - 2 && plan.kind[1] >= 0 ? 2u : 0u) |
                         (j == 1 && plan.kind[2] >= 0 ? 4u : 0u) |
                         (j == ny - 2 && plan.kind[3] >= 0 ? 8u : 0u);
      code[m] = static_cast<unsigned>(k) | (f << 15);
      if constexpr (B_REG) cbb[m] = mul_rn(cb, b[k]);
    }
  }
  const T term[4] = {T(plan.term[0]), T(plan.term[1]), T(plan.term[2]),
                     T(plan.term[3])};
  const bool neu[4] = {plan.kind[0] == 1, plan.kind[1] == 1,
                       plan.kind[2] == 1, plan.kind[3] == 1};
  __syncthreads();

  for (int s = 0; s < n_iter; ++s) {
#pragma unroll
    for (int m = 0; m < MAXC; ++m) {
      if (m * NT + tid < count) {
        unsigned e = code[m];
        // from 16 cells a thread on, keep only the code across sweeps: values
        // derived from it and hoisted out of the sweep loop would spill
        if constexpr (MAXC >= 16) asm volatile("" : "+r"(e));
        const int k = static_cast<int>(e & 0x7fffu);
        T c;
        if constexpr (B_REG) {
          c = cbb[m];
        } else {
          c = mul_rn(cb, b[k]);
        }
        const T nw = jacobi_cell(cur, k, ny, dx2, dy2, denom, c);
        nxt[k] = nw;
        const unsigned f = e >> 15;
        if (f) {
          if (f & 1u) nxt[k - ny] = neu[0] ? nw + term[0] : term[0];
          if (f & 2u) nxt[k + ny] = neu[1] ? nw + term[1] : term[1];
          if (f & 4u) nxt[k - 1] = neu[2] ? nw + term[2] : term[2];
          if (f & 8u) nxt[k + 1] = neu[3] ? nw + term[3] : term[3];
        }
      }
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (n_iter > 0 && tid < 4) {
    const int q = ((tid >> 1) ? (nx - 1) * ny : 0) + ((tid & 1) ? ny - 1 : 0);
    // the edge cell next to the corner that a Neumann BC of side s reads
    const int inner[4] = {ny, -ny, 1, -1};
    // constant indices only: a runtime index would put the plan on the stack
    int side = -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) side = tid == c ? plan.corner[c] : side;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (side == s) cur[q] = neu[s] ? cur[q + inner[s]] + term[s] : term[s];
    }
  }
  __syncthreads();
  for (int k = tid; k < n; k += NT) p_out[k] = cur[k];
}

// ---------------------------------------------------------------------------
// K1: red-black SOR to tolerance in one block. p lives in shared memory as
// the packed colour planes (plane c holds the cells with (i+j)%2 == c, cell
// (i, j) at row i, column j>>1, W = (ny+1)/2 columns), packed as it loads
// and unpacked as it leaves. Each colour's interior cells form a list in
// row-major order (`k1_cell`); thread t owns entries t, t + 1024, ... of
// both lists, and finds their plane offsets (and their rhs_c) once, before
// the sweeps. So a half-sweep has no division and no colour test, and
// every lane updates a cell of the active colour. A red cell reads only
// black neighbours and itself, and vice versa, so each half-sweep updates
// in place. Every interior cell changes exactly once per sweep, so the max
// |new - old| over the sweep is the twin's max|p_new - p|: each warp
// reduces it on the bit pattern and lane 0 folds it into a shared slot
// with one atomicMax; the slot alternates with the sweep's parity, so the
// barrier that ends the black half-sweep also publishes the error. Two
// barriers a sweep. Gate: err=1, it=1, loop while err > tol and
// it < max_iter. At exit thread 0 adds the member's sweeps (it - 1) and its
// solve to the wrapper's counts (`counts`, an int64 pair; null: no count):
// one atomic pair a member, no extra launch, no host read. The add comes
// after the output loop: the same add before it made the kernel 1 % slower.
// ---------------------------------------------------------------------------

// The n-th interior cell (row-major) of colour c on an (nx, ny) grid, as
// its packed plane offset q = i*W + (j>>1) and whether its left/right
// neighbour pair is other[q], other[q+1] (j odd) or other[q-1], other[q]
// (j even), encoded (q << 1) | (j & 1). Rows alternate between two counts:
// `a` cells on odd rows (first j = 1 + c), `b` on even rows (first j =
// 2 - c). Mirrored by poisson_kernels.py::k1_cells.
__device__ __forceinline__ unsigned k1_cell(int n, int c, int ny, int W,
                                            int* flat) {
  const int a = (ny - 1 - c) / 2, b = (ny - 2 + c) / 2;
  const int pair = n / (a + b), rem = n - pair * (a + b);
  const bool odd_row = rem < a;
  const int i = 2 * pair + (odd_row ? 1 : 2);
  const int j = (odd_row ? 1 + c : 2 - c) + 2 * (odd_row ? rem : rem - a);
  *flat = i * ny + j;
  return (static_cast<unsigned>(i * W + (j >> 1)) << 1) | (j & 1);
}

// Interior cells of colour c: (nx-1)/2 odd rows of `a`, (nx-2)/2 even rows
// of `b`.
__host__ __device__ __forceinline__ int k1_count(int nx, int ny, int c) {
  return (nx - 1) / 2 * ((ny - 1 - c) / 2) + (nx - 2) / 2 * ((ny - 2 + c) / 2);
}

// MAXC: list entries a thread owns per colour (at most); RHS_REG: rhs_c in
// registers, else in shared memory in list order. Each thread's offsets
// sit in MAXC registers, red in the low 16 bits, black in the high
// (2 * nx * W < 65536 for every grid that fits). Block m solves member m
// of a batch, `stride` elements after member m - 1, with its own gate (err,
// it and the slots are the block's): each member stops at its own sweep,
// as under the TPU kernel's vmap, whose select keeps a member once its
// gate has closed. The member's base moves the pointers; the plane
// offsets and codes are every member's own.
template <typename T, int MAXC, bool RHS_REG>
__global__ void __launch_bounds__(1024)
sor_redblack_fused_kernel(const T* __restrict__ p_in,
                          const T* __restrict__ rhs, T* __restrict__ p_out,
                          int nx, int ny, T dx2, T dy2, T denom, T beta, T tol,
                          int max_iter, long long stride,
                          unsigned long long* __restrict__ counts) {
  using U = typename Bits<T>::U;
  constexpr int NT = 1024;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ U slot[2];
  const long long member = static_cast<long long>(blockIdx.x) * stride;
  p_in += member;
  rhs += member;
  p_out += member;
  const int tid = threadIdx.x;
  const int W = (ny + 1) / 2, plane = nx * W, n = nx * ny;
  T* planes = reinterpret_cast<T*>(smem);
  T* crhs = planes + 2 * plane;  // RHS_REG false: both lists, red first
  for (int k = tid; k < n; k += NT) {
    const int i = k / ny, j = k - i * ny;
    planes[((i + j) & 1) * plane + i * W + (j >> 1)] = p_in[k];
  }
  const int count[2] = {k1_count(nx, ny, 0), k1_count(nx, ny, 1)};
  unsigned code[MAXC];
  T creg[2][MAXC];
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    code[m] = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = m * NT + tid;
      creg[c][m] = T(0);
      if (idx < count[c]) {
        int flat;
        code[m] |= k1_cell(idx, c, ny, W, &flat) << (16 * c);
        if constexpr (RHS_REG) {
          creg[c][m] = rhs[flat];
        } else {
          crhs[c * count[0] + idx] = rhs[flat];
        }
      }
    }
  }
  if (tid < 2) slot[tid] = 0;
  __syncthreads();

  const T omb = T(1) - beta;
  T err = T(1);
  int it = 1, par = 0;
  while (err > tol && it < max_iter) {
    U dmax = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T* self = planes + c * plane;
      const T* other = planes + (1 - c) * plane;
#pragma unroll
      for (int m = 0; m < MAXC; ++m) {
        const int idx = m * NT + tid;
        if (idx < count[c]) {
          unsigned e = code[m];
          // from 8 cells a thread on, decode the offsets here, every
          // sweep: hoisted out of the sweep loop, they would hold two
          // registers a cell and spill
          if constexpr (MAXC >= 8) asm volatile("" : "+r"(e));
          e = (e >> (16 * c)) & 0xffffu;
          const int q = static_cast<int>(e >> 1);
          const int qs = (e & 1u) ? q + 1 : q - 1;
          T cv;
          if constexpr (RHS_REG) {
            cv = creg[c][m];
          } else {
            cv = crhs[c * count[0] + idx];
          }
          const T old = self[q];
          const T t = dy2 * (other[q + W] + other[q - W]) +
                      dx2 * (other[q] + other[qs]) - cv;
          const T nw = beta * t / denom + omb * old;
          self[q] = nw;
          const U d = Bits<T>::of_abs(nw - old);
          dmax = d > dmax ? d : dmax;
        }
      }
      if (c == 0) __syncthreads();
    }
    dmax = warp_max(dmax);
    if ((tid & 31) == 0 && dmax != U(0)) atomicMax(&slot[par], dmax);
    // every thread read the other slot (the last sweep's) before the red
    // barrier above; the next sweep's atomics come after the one below
    if (tid == 0) slot[par ^ 1] = 0;
    __syncthreads();
    err = Bits<T>::value(slot[par]);
    ++it;
    par ^= 1;
  }
  for (int k = tid; k < n; k += NT) {
    const int i = k / ny, j = k - i * ny;
    p_out[k] = planes[((i + j) & 1) * plane + i * W + (j >> 1)];
  }
  if (tid == 0 && counts != nullptr) {
    atomicAdd(counts, static_cast<unsigned long long>(it - 1));
    atomicAdd(counts + 1, 1ull);
  }
}

// ---------------------------------------------------------------------------
// K5 beyond the card's shared memory: one colour half-sweep of red-black SOR
// over the whole grid, one thread per cell of that colour (column j = 2*jc + ((i + color) & 1)).
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
// K4 on the packed colour planes. A block owns a tile of tile_rows x
// tile_cols packed cells of both planes; its working tile adds hr = 2k rows
// and hc = k packed columns on each side: a colour half-sweep reads only
// the four nearest cells, so a cell that could not be updated from in-tile
// values (the tile's edge) taints at most the cells one unpacked step
// further in per half-sweep; after 2k half-sweeps the own cells, 2k+1
// steps in, are exact. Working cells outside the grid are never loaded or
// read (interior cells read only cells of the grid). Neighbours: up/down
// are the other colour at the same packed column; left/right are other[jc]
// and other[jc + s], where s = +1 for a cell at odd global j (2jc+1:
// neighbours 2jc and 2jc+2) and -1 at even j. The update is written in the
// TPU kernel's expression order.
// ---------------------------------------------------------------------------

// A block's working tile: its shape, its corner's global row and packed
// column, and the grid's.
struct PackedTile {
  int wr, wc, r0, c0, nx, ny, hr, hc, tile_rows, tile_cols;
};

__device__ __forceinline__ PackedTile packed_tile(int nx, int ny,
                                                  int tile_rows,
                                                  int tile_cols, int k) {
  PackedTile t;
  t.hr = 2 * k;
  t.hc = k;
  t.wr = tile_rows + 2 * t.hr;
  t.wc = tile_cols + 2 * t.hc;
  t.r0 = blockIdx.y * tile_rows - t.hr;
  t.c0 = blockIdx.x * tile_cols - t.hc;
  t.nx = nx;
  t.ny = ny;
  t.tile_rows = tile_rows;
  t.tile_cols = tile_cols;
  return t;
}

// One colour half-sweep of a working tile, in place on `self` (one warp a
// row, its lanes along the row), over the cells the own cells still depend
// on: `reach` = the half-sweeps left in the group after this one, so only
// rows within `reach` of the own rows and packed columns within
// (reach + 1) / 2 of the own columns (reach unpacked steps) can still reach
// an own cell; the rest of the halo is left stale, and no cell that matters
// reads it. A row's valid columns are one range, found once a row: interior
// j, both left/right neighbours in the tile, and the cone. rhs_c comes from
// the tile's plane in shared memory (C_SMEM) or from the unpacked global
// rhs. With `gate`, |new - old| over the own cells is max-reduced into
// *dmax.
template <typename T, bool C_SMEM>
__device__ __forceinline__ void packed_half_sweep(
    const PackedTile& t, T* __restrict__ self, const T* __restrict__ other,
    const T* __restrict__ c_tile, const T* __restrict__ rhs, int color,
    int reach, T dx2, T dy2, T denom, T beta, bool gate,
    typename Bits<T>::U* dmax) {
  using U = typename Bits<T>::U;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T omb = T(1) - beta;
  const int e = (reach + 1) / 2;
  // the last packed column with j = 2 gc + jpar <= ny - 2, for jpar 0 and 1
  const int last0 = (t.ny - 2) >> 1, last1 = (t.ny - 3) >> 1;
  const int r_lo = max(max(1, 1 - t.r0), t.hr - reach);
  const int r_hi = min(min(t.wr - 2, t.nx - 2 - t.r0),
                       t.hr + t.tile_rows - 1 + reach);
  const int cc_lo = t.hc - e, cc_hi = t.hc + t.tile_cols - 1 + e;
  for (int r = r_lo + ty; r <= r_hi; r += nwarps) {
    const int gi = t.r0 + r;
    // j parity of this colour's cells in row gi: red (i+j) even, black odd
    const int jpar = (gi + color) & 1;
    const int shift = jpar ? 1 : -1;
    // 1 <= j = 2 gc + jpar <= ny - 2, c + shift inside the tile, the cone
    const int c_lo = max(cc_lo, max(jpar ? 0 : 1, (jpar ? 0 : 1) - t.c0));
    const int c_hi = min(cc_hi, min(jpar ? t.wc - 2 : t.wc - 1,
                                    (jpar ? last1 : last0) - t.c0));
    const bool own_row = gate && r >= t.hr && r < t.hr + t.tile_rows;
    const size_t rrow = static_cast<size_t>(gi) * t.ny + jpar;
    for (int c = c_lo + tx; c <= c_hi; c += 32) {
      const int q = r * t.wc + c;
      T cv;
      if constexpr (C_SMEM) {
        cv = c_tile[q];
      } else {  // rhs_c at j = 2 gc + jpar
        cv = rhs[rrow + 2 * (t.c0 + c)];
      }
      const T old = self[q];
      const T tt = dy2 * (other[q + t.wc] + other[q - t.wc]) +
                   dx2 * (other[q] + other[q + shift]) - cv;
      const T nw = beta * tt / denom + omb * old;
      self[q] = nw;
      if (own_row && c >= t.hc && c < t.hc + t.tile_cols) {
        const U d = Bits<T>::of_abs(nw - old);
        *dmax = d > *dmax ? d : *dmax;
      }
    }
  }
}

// K4's non-resident route: one gate group (k sweeps) per launch, one block
// per tile. Reads the (Rin, Bin) snapshot, writes (Rout, Bout): blocks
// whose halos overlap never see each other's writes. The last sweep's max
// |new - old| over own interior cells is max-reduced per warp and folded
// into *err with one atomicMax on the bit pattern; the host reads it.
template <typename T>
__global__ void __launch_bounds__(1024)
sor_packed_group_kernel(const T* __restrict__ Rin, const T* __restrict__ Bin,
                        const T* __restrict__ rhs, T* __restrict__ Rout,
                        T* __restrict__ Bout, int nx, int ny, int tile_rows,
                        int tile_cols, int k, T dx2, T dy2, T denom, T beta,
                        typename Bits<T>::U* __restrict__ err) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ny2 = ny / 2;
  const PackedTile t = packed_tile(nx, ny, tile_rows, tile_cols, k);
  T* sR = reinterpret_cast<T*>(smem);
  T* sB = sR + t.wr * t.wc;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int r = ty; r < t.wr; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi < 0 || gi >= nx) continue;
    for (int c = tx; c < t.wc; c += 32) {
      const int gc = t.c0 + c;
      if (gc < 0 || gc >= ny2) continue;
      const size_t g = static_cast<size_t>(gi) * ny2 + gc;
      sR[r * t.wc + c] = Rin[g];
      sB[r * t.wc + c] = Bin[g];
    }
  }
  __syncthreads();

  U dmax = 0;
  for (int sweep = 0; sweep < k; ++sweep) {
    const bool last = sweep == k - 1;
    const int left = 2 * (k - 1 - sweep);  // half-sweeps after this sweep
    packed_half_sweep<T, false>(t, sR, sB, nullptr, rhs, 0, left + 1, dx2,
                                dy2, denom, beta, last, &dmax);
    __syncthreads();
    packed_half_sweep<T, false>(t, sB, sR, nullptr, rhs, 1, left, dx2, dy2,
                                denom, beta, last, &dmax);
    __syncthreads();
  }

  for (int r = t.hr + ty; r < t.hr + tile_rows; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi < 0 || gi >= nx) continue;
    for (int c = t.hc + tx; c < t.hc + tile_cols; c += 32) {
      const int gc = t.c0 + c;
      if (gc < 0 || gc >= ny2) continue;
      const size_t g = static_cast<size_t>(gi) * ny2 + gc;
      Rout[g] = sR[r * t.wc + c];
      Bout[g] = sB[r * t.wc + c];
    }
  }
  dmax = warp_max(dmax);
  if (tx == 0 && dmax != U(0)) atomicMax(err, dmax);
}

// All blocks of a cooperative launch meet here; `target` is the number of
// arrivals the counter reaches at this barrier (barrier number x blocks).
// Thread 0's fences release the block's global writes before it arrives
// and acquire the other blocks' after (as cooperative_groups' grid sync).
__device__ __forceinline__ void grid_barrier(unsigned* arrived,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    // a watchdog: blocks that never arrive (a fault, never a slow block:
    // the launch keeps them all resident) end the kernel with an error
    // after a few seconds instead of hanging the card
    for (long spins = 0;
         *reinterpret_cast<volatile unsigned*>(arrived) < target; ++spins) {
      if (spins > (1l << 22)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The resident route of K4 and K5: the whole solve in one cooperative
// launch, every block resident on its own SM. A block packs its working tile of p (and,
// with C_SMEM, of rhs_c) into shared memory as it loads them, and keeps
// them there for the whole solve. Each gate group: k sweeps in shared
// memory; the block folds its own cells' last-sweep max|dp| into the
// group's error slot (one atomicMax per warp) and writes its own cells to
// the exchange planes of the group's parity; grid barrier; every block
// reads the slot and applies the TPU while_loop's gate (err from +inf,
// it from 1, it += k), so all take the same decision; a block that goes
// on reloads only its halo ring from the exchange planes (through L2:
// another SM wrote them). The exchange planes ping-pong, so a block that
// writes group g+1's cells never overwrites what a slower block is still
// reading of group g. At exit block (0, 0)'s thread 0 adds the solve's
// sweeps (it - 1) and the solve to `counts` (an int64 pair; null: no count),
// and the own cells go out unpacked. ODD: an odd
// ny, whose loads and stores skip j = ny (an instance of its own, so that
// K4's even grids run the code without those guards).
template <typename T, bool C_SMEM, bool ODD>
__global__ void __launch_bounds__(1024)
sor_packed_resident_kernel(const T* __restrict__ p_in,
                           const T* __restrict__ rhs, T* __restrict__ p_out,
                           T* __restrict__ xch,
                           typename Bits<T>::U* __restrict__ errs,
                           unsigned* __restrict__ arrived, int nx, int ny,
                           int tile_rows, int tile_cols, int k, T dx2, T dy2,
                           T denom, T beta, T tol, int max_iter,
                           unsigned long long* __restrict__ counts) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = ODD ? (ny + 1) / 2 : ny / 2;  // packed columns
  const PackedTile t = packed_tile(nx, ny, tile_rows, tile_cols, k);
  const int cells = t.wr * t.wc;
  T* sR = reinterpret_cast<T*>(smem);
  T* sB = sR + cells;
  T* sCR = C_SMEM ? sB + cells : nullptr;
  T* sCB = C_SMEM ? sCR + cells : nullptr;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = static_cast<size_t>(nx) * W;
  const unsigned nblocks = gridDim.x * gridDim.y;

  // load the working tile, packing as it comes: R[i, jc] = p[i, 2jc + i%2];
  // at an odd ny the last packed column of one plane in each row (j = ny)
  // lies outside the grid, is loaded as 0 and is never read by an update
  for (int r = ty; r < t.wr; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi < 0 || gi >= nx) continue;
    const bool even_row = (gi & 1) == 0;
    for (int c = tx; c < t.wc; c += 32) {
      const int gc = t.c0 + c;
      if (gc < 0 || gc >= W) continue;
      const size_t g = static_cast<size_t>(gi) * ny + 2 * gc;
      const bool pair = !ODD || 2 * gc + 1 < ny;
      const T a = p_in[g], b = pair ? p_in[g + 1] : T(0);
      sR[r * t.wc + c] = even_row ? a : b;
      sB[r * t.wc + c] = even_row ? b : a;
      if constexpr (C_SMEM) {
        const T ca = rhs[g], cb = pair ? rhs[g + 1] : T(0);
        sCR[r * t.wc + c] = even_row ? ca : cb;
        sCB[r * t.wc + c] = even_row ? cb : ca;
      }
    }
  }
  __syncthreads();

  T err = Bits<T>::value(Bits<T>::kInf);
  int it = 1, g = 0;
  while (err > tol && it < max_iter) {
    U dmax = 0;
    for (int sweep = 0; sweep < k; ++sweep) {
      const bool last = sweep == k - 1;
      const int left = 2 * (k - 1 - sweep);  // half-sweeps after this sweep
      packed_half_sweep<T, C_SMEM>(t, sR, sB, sCR, rhs, 0, left + 1, dx2, dy2,
                                   denom, beta, last, &dmax);
      __syncthreads();
      packed_half_sweep<T, C_SMEM>(t, sB, sR, sCB, rhs, 1, left, dx2, dy2,
                                   denom, beta, last, &dmax);
      __syncthreads();
    }
    dmax = warp_max(dmax);
    if (tx == 0 && dmax != U(0)) atomicMax(errs + g, dmax);
    T* XR = xch + (g & 1) * 2 * plane;
    T* XB = XR + plane;
    for (int r = t.hr + ty; r < t.hr + tile_rows; r += nwarps) {
      const int gi = t.r0 + r;
      if (gi >= nx) break;
      for (int c = t.hc + tx; c < t.hc + tile_cols; c += 32) {
        const int gc = t.c0 + c;
        if (gc >= W) break;
        const size_t gq = static_cast<size_t>(gi) * W + gc;
        XR[gq] = sR[r * t.wc + c];
        XB[gq] = sB[r * t.wc + c];
      }
    }
    grid_barrier(arrived, (g + 1) * nblocks);
    err = Bits<T>::value(__ldcg(errs + g));
    it += k;
    ++g;
    if (err > tol && it < max_iter) {
      // the halo ring: every working cell of the grid outside the own tile
      for (int r = ty; r < t.wr; r += nwarps) {
        const int gi = t.r0 + r;
        if (gi < 0 || gi >= nx) continue;
        const bool own_row = r >= t.hr && r < t.hr + tile_rows;
        for (int c = tx; c < t.wc; c += 32) {
          const int gc = t.c0 + c;
          if (gc < 0 || gc >= W ||
              (own_row && c >= t.hc && c < t.hc + tile_cols))
            continue;
          const size_t gq = static_cast<size_t>(gi) * W + gc;
          sR[r * t.wc + c] = __ldcg(XR + gq);
          sB[r * t.wc + c] = __ldcg(XB + gq);
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      counts != nullptr) {
    atomicAdd(counts, static_cast<unsigned long long>(it - 1));
    atomicAdd(counts + 1, 1ull);
  }

  for (int r = t.hr + ty; r < t.hr + tile_rows; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi >= nx) break;
    const bool even_row = (gi & 1) == 0;
    for (int c = t.hc + tx; c < t.hc + tile_cols; c += 32) {
      const int gc = t.c0 + c;
      if (gc >= W) break;
      const size_t gq = static_cast<size_t>(gi) * ny + 2 * gc;
      const T vr = sR[r * t.wc + c], vb = sB[r * t.wc + c];
      p_out[gq] = even_row ? vr : vb;
      if (!ODD || 2 * gc + 1 < ny) p_out[gq + 1] = even_row ? vb : vr;
    }
  }
}

// ---------------------------------------------------------------------------
// K2's multi-block form. A block owns a tile of tile_rows x tile_cols cells
// of the grid (boundary rows and columns included); its working tile adds a
// halo of k cells on each side, the reach of k Jacobi sweeps. Each group of
// kg <= k sweeps runs in shared memory on a ping-pong pair (the update
// reads only old values; both buffers are loaded with p, so boundary cells
// that no BC writes hold their value in either), each sweep cut to the
// cells the own cells still depend on: `reach` = the sweeps left in the
// group after this one, so only cells within reach of the own tile are
// updated, and no cell that matters reads the stale rest. The tile applies
// K2's edge plan in every sweep, halo included: the thread that sweeps an
// interior cell next to an edge writes that edge cell (the cone of a cell
// holds the interior cell next to it: that one is never farther from the
// own tile). No update reads a corner, so the tile that owns a corner
// writes it once, after the last sweep, from the edge cell next to it; the
// tile plan leaves every tile at least two rows and columns, so that cell
// is an own cell. cb * b is rounded on its own into shared memory (C_SMEM)
// or every sweep from global memory (L2).
//
// RESIDENT: the whole solve in one cooperative launch, one block a SM:
// between groups a block writes its own cells to the exchange plane of the
// group's parity (through L2), meets the others at the grid barrier and
// reloads its halo; the planes ping-pong, so a block that writes group
// g+1's cells never overwrites what a slower block still reads of group g.
// Otherwise one group a launch (n_sweeps <= k) from p_in to p_out.
// n_sweeps = 0 copies p.
// ---------------------------------------------------------------------------

struct JacobiTile {
  int wr, wc, r0, c0, h, tile_rows, tile_cols;
};

// One sweep of the working tile `cur` into `nxt` (one warp a row, its lanes
// along the row) over the interior cells within `reach` of the own tile,
// with the edge plan's writes.
template <typename T, bool C_SMEM>
__device__ __forceinline__ void jacobi_tile_sweep(
    const JacobiTile& t, int nx, int ny, const T* __restrict__ cur,
    T* __restrict__ nxt, const T* __restrict__ cbb, const T* __restrict__ b,
    int reach, T dx2, T dy2, T denom, T cb, const EdgePlan& plan) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wc = t.wc;
  const T term[4] = {T(plan.term[0]), T(plan.term[1]), T(plan.term[2]),
                     T(plan.term[3])};
  const bool neu[4] = {plan.kind[0] == 1, plan.kind[1] == 1,
                       plan.kind[2] == 1, plan.kind[3] == 1};
  // working columns of the interior cells next to the bottom and top edges,
  // where those sides have a BC (else -1: no lane matches)
  const int c_bot = plan.kind[2] >= 0 ? 1 - t.c0 : -1;
  const int c_top = plan.kind[3] >= 0 ? ny - 2 - t.c0 : -1;
  const int r_lo = max(t.h - reach, 1 - t.r0);
  const int r_hi = min(t.h + t.tile_rows - 1 + reach, nx - 2 - t.r0);
  const int c_lo = max(t.h - reach, 1 - t.c0);
  const int c_hi = min(t.h + t.tile_cols - 1 + reach, ny - 2 - t.c0);
  for (int r = r_lo + ty; r <= r_hi; r += nwarps) {
    const int gi = t.r0 + r;
    const bool left = gi == 1 && plan.kind[0] >= 0;
    const bool right = gi == nx - 2 && plan.kind[1] >= 0;
    const size_t grow = static_cast<size_t>(gi) * ny + t.c0;
    for (int c = c_lo + tx; c <= c_hi; c += 32) {
      const int q = r * wc + c;
      T cv;
      if constexpr (C_SMEM) {
        cv = cbb[q];
      } else {
        cv = mul_rn(cb, __ldg(b + grow + c));
      }
      const T nw = jacobi_cell(cur, q, wc, dx2, dy2, denom, cv);
      nxt[q] = nw;
      if (left | right | (c == c_bot) | (c == c_top)) {
        if (left) nxt[q - wc] = neu[0] ? nw + term[0] : term[0];
        if (right) nxt[q + wc] = neu[1] ? nw + term[1] : term[1];
        if (c == c_bot) nxt[q - 1] = neu[2] ? nw + term[2] : term[2];
        if (c == c_top) nxt[q + 1] = neu[3] ? nw + term[3] : term[3];
      }
    }
  }
}

template <typename T, bool C_SMEM, bool RESIDENT>
__global__ void __launch_bounds__(1024)
jacobi_tiled_kernel(const T* __restrict__ p_in, const T* __restrict__ b,
                    T* __restrict__ p_out, T* __restrict__ xch,
                    unsigned* __restrict__ arrived, int nx, int ny,
                    int tile_rows, int tile_cols, int k, int n_sweeps,
                    int corners, T dx2, T dy2, T denom, T cb, EdgePlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  JacobiTile t;
  t.h = k;
  t.tile_rows = tile_rows;
  t.tile_cols = tile_cols;
  t.wr = tile_rows + 2 * k;
  t.wc = tile_cols + 2 * k;
  t.r0 = blockIdx.y * tile_rows - k;
  t.c0 = blockIdx.x * tile_cols - k;
  const int cells = t.wr * t.wc;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + cells;
  T* cbb = C_SMEM ? nxt + cells : nullptr;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // the working cells inside the grid; outside it nothing is loaded or read
  for (int r = ty; r < t.wr; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi < 0 || gi >= nx) continue;
    for (int c = tx; c < t.wc; c += 32) {
      const int gj = t.c0 + c;
      if (gj < 0 || gj >= ny) continue;
      const size_t g = static_cast<size_t>(gi) * ny + gj;
      const T v = p_in[g];
      cur[r * t.wc + c] = v;
      nxt[r * t.wc + c] = v;
      if constexpr (C_SMEM) cbb[r * t.wc + c] = mul_rn(cb, b[g]);
    }
  }
  __syncthreads();

  const int groups = (n_sweeps + k - 1) / k;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const unsigned nblocks = gridDim.x * gridDim.y;
  for (int g = 0; g < groups; ++g) {
    const int kg = min(k, n_sweeps - g * k);
    for (int s = 0; s < kg; ++s) {
      jacobi_tile_sweep<T, C_SMEM>(t, nx, ny, cur, nxt, cbb, b, kg - 1 - s,
                                   dx2, dy2, denom, cb, plan);
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if constexpr (RESIDENT) {
      if (g + 1 < groups) {
        T* X = xch + (g & 1) * plane;
        for (int r = t.h + ty; r < t.h + tile_rows; r += nwarps) {
          const int gi = t.r0 + r;
          if (gi >= nx) break;
          for (int c = t.h + tx; c < t.h + tile_cols; c += 32) {
            const int gj = t.c0 + c;
            if (gj >= ny) break;
            __stcg(X + static_cast<size_t>(gi) * ny + gj, cur[r * t.wc + c]);
          }
        }
        grid_barrier(arrived, (g + 1) * nblocks);
        // the halo ring: every working cell of the grid outside the own tile
        for (int r = ty; r < t.wr; r += nwarps) {
          const int gi = t.r0 + r;
          if (gi < 0 || gi >= nx) continue;
          const bool own_row = r >= t.h && r < t.h + tile_rows;
          for (int c = tx; c < t.wc; c += 32) {
            const int gj = t.c0 + c;
            if (gj < 0 || gj >= ny ||
                (own_row && c >= t.h && c < t.h + tile_cols))
              continue;
            cur[r * t.wc + c] = __ldcg(X + static_cast<size_t>(gi) * ny + gj);
          }
        }
        __syncthreads();
      }
    }
  }

  if (corners && threadIdx.x < 4) {
    const int ci = (threadIdx.x >> 1) ? nx - 1 : 0;
    const int cj = (threadIdx.x & 1) ? ny - 1 : 0;
    const int r = ci - t.r0, c = cj - t.c0;
    if (r >= t.h && r < t.h + tile_rows && c >= t.h && c < t.h + tile_cols) {
      const int q = r * t.wc + c;
      // the edge cell next to the corner that a Neumann BC of side s reads
      const int inner[4] = {t.wc, -t.wc, 1, -1};
      int side = -1;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        side = threadIdx.x == m ? plan.corner[m] : side;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (side == s) {
          const T term = T(plan.term[s]);
          cur[q] = plan.kind[s] == 1 ? cur[q + inner[s]] + term : term;
        }
      }
    }
  }
  __syncthreads();
  for (int r = t.h + ty; r < t.h + tile_rows; r += nwarps) {
    const int gi = t.r0 + r;
    if (gi >= nx) break;
    for (int c = t.h + tx; c < t.h + tile_cols; c += 32) {
      const int gj = t.c0 + c;
      if (gj >= ny) break;
      p_out[static_cast<size_t>(gi) * ny + gj] = cur[r * t.wc + c];
    }
  }
}

template <typename T, int MAXC>
cudaError_t launch_jacobi_fused(const T* p, const T* b, T* out, int nx,
                                int ny, int n_iter, T dx2, T dy2, T denom,
                                T cb, const EdgePlan& plan, int batch,
                                long long stride, cudaStream_t s) {
  // cb * b in registers while a thread's share is at most 16 words
  constexpr bool kBReg = MAXC * sizeof(T) <= 64;
  auto kernel = jacobi_fused_kernel<T, MAXC, kBReg>;
  const size_t smem = 2 * static_cast<size_t>(nx) * ny * sizeof(T);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<batch, 1024, smem, s>>>(p, b, out, nx, ny, n_iter, dx2, dy2,
                                   denom, cb, plan, stride);
  return cudaGetLastError();
}

// K2's entry. plan_spec: the edge plan as 12 doubles, kind[4], corner[4],
// term[4] (poisson_kernels.py::k2_edge_plan). batch members, one block
// each, `stride` elements apart (batch 1: the single solve). Picks the
// instance whose MAXC covers this grid's interior cells per thread.
template <typename T>
int jacobi_fused(const void* p, const void* b, void* out, int nx, int ny,
                 int n_iter, double dx2, double dy2, double denom, double cb,
                 const double* plan_spec, int batch, long long stride,
                 void* stream) {
  if (nx < 3 || ny < 3 || nx * ny >= (1 << 15) || n_iter < 0 || batch < 1 ||
      (batch > 1 && stride < static_cast<long long>(nx) * ny))
    return cudaErrorInvalidValue;
  EdgePlan plan;
  const cudaError_t e = make_plan(plan_spec, &plan);
  if (e != cudaSuccess) return e;
  const int per_thread = ((nx - 2) * (ny - 2) + 1023) / 1024;
  const T* pp = static_cast<const T*>(p);
  const T* bb = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NS_K2(M)                                                             \
  if (per_thread <= M)                                                       \
    return launch_jacobi_fused<T, M>(pp, bb, o, nx, ny, n_iter, T(dx2),      \
                                     T(dy2), T(denom), T(cb), plan, batch,   \
                                     stride, s);
  NS_K2(1)
  NS_K2(2)
  NS_K2(4)
  NS_K2(8)
  NS_K2(16)
  NS_K2(32)
#undef NS_K2
  return cudaErrorInvalidValue;
}

template <typename T>
void* jacobi_tiled_kernel_ptr(int c_smem, int resident) {
  if (resident)
    return c_smem ? reinterpret_cast<void*>(jacobi_tiled_kernel<T, true, true>)
                  : reinterpret_cast<void*>(jacobi_tiled_kernel<T, false, true>);
  return c_smem ? reinterpret_cast<void*>(jacobi_tiled_kernel<T, true, false>)
                : reinterpret_cast<void*>(jacobi_tiled_kernel<T, false, false>);
}

size_t jacobi_tiled_smem(int tile_rows, int tile_cols, int k, int c_smem,
                         size_t itemsize) {
  return (c_smem ? 3 : 2) * static_cast<size_t>(tile_rows + 2 * k) *
         (tile_cols + 2 * k) * itemsize;
}

// Blocks of 1024 threads of the resident Jacobi kernel one SM holds at
// once, for the wrapper's co-residency check.
template <typename T>
int jacobi_resident_occupancy(int tile_rows, int tile_cols, int k, int c_smem,
                              int* blocks_per_sm) {
  const void* kernel = jacobi_tiled_kernel_ptr<T>(c_smem, 1);
  const size_t smem =
      jacobi_tiled_smem(tile_rows, tile_cols, k, c_smem, sizeof(T));
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       1024, smem);
}

// K2's multi-block entry. resident: one cooperative launch (xch: two
// (nx, ny) exchange planes; arrived: the grid barrier's counter, zeroed
// here). Otherwise one launch per group of k sweeps, alternating between
// `out` and `scratch` so that the last lands in `out` (`p` is only read).
// plan_spec: the edge plan, as for jacobi_fused. Every tile must hold at
// least two rows and two columns (a ragged last tile of one would own a
// corner without the edge cell next to it).
template <typename T>
int jacobi_multiblock(const void* p, const void* b, void* out, void* scratch,
                      void* xch, void* arrived, int nx, int ny, int tile_rows,
                      int tile_cols, int k, int c_smem, int resident,
                      int n_iter, double dx2, double dy2, double denom,
                      double cb, const double* plan_spec, void* stream) {
  if (nx < 3 || ny < 3 || k < 1 || n_iter < 0 || tile_rows < 2 ||
      tile_cols < 2 || nx % tile_rows == 1 || ny % tile_cols == 1)
    return cudaErrorInvalidValue;
  EdgePlan plan;
  cudaError_t e = make_plan(plan_spec, &plan);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kernel = jacobi_tiled_kernel_ptr<T>(c_smem, resident);
  const size_t smem =
      jacobi_tiled_smem(tile_rows, tile_cols, k, c_smem, sizeof(T));
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ny + tile_cols - 1) / tile_cols,
                  (nx + tile_rows - 1) / tile_rows);
  const T* a_p = static_cast<const T*>(p);
  const T* a_b = static_cast<const T*>(b);
  T* a_out = static_cast<T*>(out);
  T* a_xch = static_cast<T*>(xch);
  unsigned* a_arrived = static_cast<unsigned*>(arrived);
  T a_dx2 = T(dx2), a_dy2 = T(dy2), a_denom = T(denom), a_cb = T(cb);
  int n_sweeps = n_iter, corners = n_iter > 0;
  void* args[] = {&a_p,     &a_b,      &a_out,   &a_xch,     &a_arrived,
                  &nx,      &ny,       &tile_rows, &tile_cols, &k,
                  &n_sweeps, &corners, &a_dx2,   &a_dy2,     &a_denom,
                  &a_cb,    &plan};
  if (resident) {
    e = cudaMemsetAsync(arrived, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return e;
    return cudaLaunchCooperativeKernel(kernel, grid, dim3(1024), args, smem,
                                       s);
  }
  const int groups = n_iter > 0 ? (n_iter + k - 1) / k : 1;
  T* bufs[2] = {static_cast<T*>(out), static_cast<T*>(scratch)};
  int w = groups % 2 == 1 ? 0 : 1;
  for (int g = 0; g < groups; ++g) {
    a_out = bufs[w];
    n_sweeps = max(min(k, n_iter - g * k), 0);
    corners = n_iter > 0 && g == groups - 1;
    e = cudaLaunchKernel(kernel, grid, dim3(1024), args, smem, s);
    if (e != cudaSuccess) return e;
    a_p = a_out;
    w ^= 1;
  }
  return cudaSuccess;
}

template <typename T, int MAXC>
cudaError_t launch_sor_fused(const T* p, const T* rhs, T* out, int nx, int ny,
                             T dx2, T dy2, T denom, T beta, T tol,
                             int max_iter, int batch, long long stride,
                             unsigned long long* counts, cudaStream_t s) {
  // rhs_c in registers while a thread's share of both colours is at most
  // 16 words (64 registers a thread at 1024 threads); else in shared memory
  constexpr bool kRhsReg = 2 * MAXC * sizeof(T) <= 64;
  auto kernel = sor_redblack_fused_kernel<T, MAXC, kRhsReg>;
  const int cells = k1_count(nx, ny, 0) + k1_count(nx, ny, 1);
  const size_t smem = (2 * static_cast<size_t>(nx) * ((ny + 1) / 2) +
                       (kRhsReg ? 0 : cells)) * sizeof(T);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<batch, 1024, smem, s>>>(p, rhs, out, nx, ny, dx2, dy2, denom,
                                   beta, tol, max_iter, stride, counts);
  return cudaGetLastError();
}

// K1's entry: batch members, one block each, `stride` elements apart
// (batch 1: the single solve); picks the instance whose MAXC covers this
// grid's cells per thread (poisson_kernels.py::k1_layout mirrors the
// choice). counts: the wrapper's (sweeps, solves) int64 pair, or null.
template <typename T>
int sor_redblack_fused(const void* p, const void* rhs, void* out, int nx,
                       int ny, double dx2, double dy2, double denom,
                       double beta, double tol, int max_iter, int batch,
                       long long stride, void* counts, void* stream) {
  if (nx < 3 || ny < 3 || 2 * nx * ((ny + 1) / 2) > 65535 || batch < 1 ||
      (batch > 1 && stride < static_cast<long long>(nx) * ny))
    return cudaErrorInvalidValue;
  const int most = max(k1_count(nx, ny, 0), k1_count(nx, ny, 1));
  const int per_thread = (most + 1023) / 1024;
  const T* pp = static_cast<const T*>(p);
  const T* cc = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  auto* n = static_cast<unsigned long long*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NS_K1(M)                                                             \
  if (per_thread <= M)                                                       \
    return launch_sor_fused<T, M>(pp, cc, o, nx, ny, T(dx2), T(dy2),         \
                                  T(denom), T(beta), T(tol), max_iter,      \
                                  batch, stride, n, s);
  NS_K1(1)
  NS_K1(2)
  NS_K1(4)
  NS_K1(8)
  NS_K1(16)
#undef NS_K1
  return cudaErrorInvalidValue;
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
int sor_redblack_packed_group(const void* R, const void* B, const void* rhs,
                              void* Rout, void* Bout, void* err, int nx,
                              int ny, int tile_rows, int tile_cols,
                              double dx2, double dy2, double denom,
                              double beta, int k, void* stream) {
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
      static_cast<const T*>(rhs), static_cast<T*>(Rout),
      static_cast<T*>(Bout), nx, ny, tile_rows, tile_cols, k, T(dx2), T(dy2),
      T(denom), T(beta), static_cast<U*>(err));
  return cudaGetLastError();
}

template <typename T>
void* packed_resident_kernel(int c_smem, int odd) {
  if (odd)
    return c_smem
               ? reinterpret_cast<void*>(sor_packed_resident_kernel<T, true, true>)
               : reinterpret_cast<void*>(
                     sor_packed_resident_kernel<T, false, true>);
  return c_smem
             ? reinterpret_cast<void*>(sor_packed_resident_kernel<T, true, false>)
             : reinterpret_cast<void*>(sor_packed_resident_kernel<T, false, false>);
}

size_t packed_resident_smem(int tile_rows, int tile_cols, int k, int c_smem,
                            size_t itemsize) {
  return (c_smem ? 4 : 2) * static_cast<size_t>(tile_rows + 4 * k) *
         (tile_cols + 2 * k) * itemsize;
}

// Blocks of 1024 threads of the resident kernel one SM holds at once, for
// the wrapper's co-residency check.
template <typename T>
int sor_packed_resident_occupancy(int tile_rows, int tile_cols, int k,
                                  int c_smem, int odd, int* blocks_per_sm) {
  const void* kernel = packed_resident_kernel<T>(c_smem, odd);
  const size_t smem =
      packed_resident_smem(tile_rows, tile_cols, k, c_smem, sizeof(T));
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       1024, smem);
}

// A whole K4 or K5 solve in one cooperative launch (the resident route).
// xch: 4 (nx, (ny+1)/2) planes; errs: n_slots gate slots, one per group; arrived:
// the grid barrier's counter. The slots and the counter are zeroed here.
// counts: the wrapper's (sweeps, solves) int64 pair, or null.
template <typename T>
int sor_redblack_packed_resident(const void* p, const void* rhs, void* out,
                                 void* xch, void* errs, void* arrived,
                                 int n_slots, int nx, int ny, int tile_rows,
                                 int tile_cols, int c_smem, double dx2,
                                 double dy2, double denom, double beta,
                                 double tol, int max_iter, int k,
                                 void* counts, void* stream) {
  using U = typename Bits<T>::U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = max_iter > 1 ? (max_iter - 1 + k - 1) / k : 0;
  if (k < 1 || tile_rows < 1 || tile_cols < 1 || nx < 3 || ny < 3 ||
      n_slots < max(groups, 1))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(errs, 0, n_slots * sizeof(U), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(arrived, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  const void* kernel = packed_resident_kernel<T>(c_smem, ny % 2);
  const size_t smem =
      packed_resident_smem(tile_rows, tile_cols, k, c_smem, sizeof(T));
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(((ny + 1) / 2 + tile_cols - 1) / tile_cols,
                  (nx + tile_rows - 1) / tile_rows);
  const T* a_p = static_cast<const T*>(p);
  const T* a_rhs = static_cast<const T*>(rhs);
  T* a_out = static_cast<T*>(out);
  T* a_xch = static_cast<T*>(xch);
  U* a_errs = static_cast<U*>(errs);
  unsigned* a_arrived = static_cast<unsigned*>(arrived);
  auto* a_counts = static_cast<unsigned long long*>(counts);
  T a_dx2 = T(dx2), a_dy2 = T(dy2), a_denom = T(denom), a_beta = T(beta),
    a_tol = T(tol);
  void* args[] = {&a_p,   &a_rhs,     &a_out,     &a_xch,  &a_errs,
                  &a_arrived, &nx,    &ny,        &tile_rows, &tile_cols,
                  &k,     &a_dx2,     &a_dy2,     &a_denom, &a_beta,
                  &a_tol, &max_iter, &a_counts};
  return cudaLaunchCooperativeKernel(kernel, grid, dim3(1024), args, smem, s);
}

}  // namespace ns

extern "C" {

const char* ns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define NS_JACOBI(SUFFIX, T)                                                  \
  int ns_jacobi_fused_##SUFFIX(const void* p, const void* b, void* out,      \
                               int nx, int ny, int n_iter, double dx2,       \
                               double dy2, double denom, double cb,          \
                               const double* plan_spec, int batch,           \
                               long long stride, void* stream) {             \
    return ns::jacobi_fused<T>(p, b, out, nx, ny, n_iter, dx2, dy2, denom,   \
                               cb, plan_spec, batch, stride, stream);        \
  }
NS_JACOBI(f32, float)
NS_JACOBI(f64, double)

#define NS_JACOBI_MB(SUFFIX, T)                                               \
  int ns_jacobi_multiblock_##SUFFIX(                                          \
      const void* p, const void* b, void* out, void* scratch, void* xch,     \
      void* arrived, int nx, int ny, int tile_rows, int tile_cols, int k,    \
      int c_smem, int resident, int n_iter, double dx2, double dy2,          \
      double denom, double cb, const double* plan_spec, void* stream) {      \
    return ns::jacobi_multiblock<T>(p, b, out, scratch, xch, arrived, nx,    \
                                    ny, tile_rows, tile_cols, k, c_smem,     \
                                    resident, n_iter, dx2, dy2, denom, cb,   \
                                    plan_spec, stream);                      \
  }                                                                          \
  int ns_jacobi_resident_occupancy_##SUFFIX(int tile_rows, int tile_cols,    \
                                            int k, int c_smem,               \
                                            int* blocks_per_sm) {            \
    return ns::jacobi_resident_occupancy<T>(tile_rows, tile_cols, k, c_smem, \
                                            blocks_per_sm);                  \
  }
NS_JACOBI_MB(f32, float)
NS_JACOBI_MB(f64, double)

#define NS_SOR_FUSED(SUFFIX, T)                                               \
  int ns_sor_redblack_fused_##SUFFIX(const void* p, const void* rhs,         \
                                     void* out, int nx, int ny, double dx2,  \
                                     double dy2, double denom, double beta,  \
                                     double tol, int max_iter, int batch,    \
                                     long long stride, void* counts,         \
                                     void* stream) {                         \
    return ns::sor_redblack_fused<T>(p, rhs, out, nx, ny, dx2, dy2, denom,   \
                                     beta, tol, max_iter, batch, stride,     \
                                     counts, stream);                        \
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
      const void* R, const void* B, const void* rhs, void* Rout, void* Bout, \
      void* err, int nx, int ny, int tile_rows, int tile_cols, double dx2,   \
      double dy2, double denom, double beta, int k, void* stream) {          \
    return ns::sor_redblack_packed_group<T>(R, B, rhs, Rout, Bout, err, nx,  \
                                            ny, tile_rows, tile_cols, dx2,   \
                                            dy2, denom, beta, k, stream);    \
  }                                                                          \
  int ns_sor_redblack_packed_resident_##SUFFIX(                              \
      const void* p, const void* rhs, void* out, void* xch, void* errs,      \
      void* arrived, int n_slots, int nx, int ny, int tile_rows,             \
      int tile_cols, int c_smem, double dx2, double dy2, double denom,       \
      double beta, double tol, int max_iter, int k, void* counts,            \
      void* stream) {                                                        \
    return ns::sor_redblack_packed_resident<T>(                              \
        p, rhs, out, xch, errs, arrived, n_slots, nx, ny, tile_rows,         \
        tile_cols, c_smem, dx2, dy2, denom, beta, tol, max_iter, k, counts,  \
        stream);                                                             \
  }                                                                          \
  int ns_sor_packed_resident_occupancy_##SUFFIX(                             \
      int tile_rows, int tile_cols, int k, int c_smem, int odd,              \
      int* blocks_per_sm) {                                                  \
    return ns::sor_packed_resident_occupancy<T>(tile_rows, tile_cols, k,     \
                                                c_smem, odd, blocks_per_sm); \
  }
NS_SOR_PACKED(f32, float)
NS_SOR_PACKED(f64, double)

}  // extern "C"
