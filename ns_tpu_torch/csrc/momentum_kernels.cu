// K3 momentum_explicit_fused for Hopper (sm_90a): the chorin_fd explicit
// predictor (AB2 advection + AB2 diffusion of u and v) and the u/v BC edge
// writes, in one launch. Replaces ns_tpu/ops/pallas/momentum_kernels.py
// ::momentum_explicit_fused_pallas (entry ::momentum_explicit_fused_any).
//
// What bounds it on the H100: bytes, in principle. Per cell it reads four
// fields and writes two (6 * itemsize bytes) for ~80 FLOPs, below the
// ridge point; but 16 of them are IEEE divisions, kept as the TPU kernel
// writes them (under the reference quirk with 2dx == 2dy the y-derivative's
// quotient is the x-derivative's own, so 12), and their issue keeps it
// above the byte bound. Each block stages its tile of the four inputs,
// with a one-row and one-vector halo, in shared memory by cp.async, 16
// bytes a copy where the rows allow it (ny * itemsize a multiple of 16 and
// aligned pointers; else one element a copy), and each thread computes a
// 16-byte vector of u* and of v* from there and stores each with one
// 16-byte store. No intermediate field goes to device memory.
//
// The BC lists come as their edge plans (poisson_kernels.py::k2_edge_plan):
// a side's non-corner cells hold what its last BC writes (its term, or the
// fresh interior cell next to it plus its term; the input's value where the
// side has no BC), and a corner what the last BC of its two sides writes,
// read from the edge cell next to it, which is itself a term, the input's
// value or the fresh diagonal interior cell plus a term. The thread that
// owns an edge cell recomputes the interior cell it needs from the staged
// inputs, so no cell waits for another thread and the whole step is one
// launch. Tiles that would hold a single row or column of the grid's last
// rows or columns are shifted back to end at the grid's edge (the overlap
// is written twice with the same values), so every tile holds the interior
// cells its edge cells read.
//
// A batch of members (the FD ensemble, run by the JAX package under vmap,
// which gives the TPU kernel's grid a member axis) is one launch with the
// members on blockIdx.z, each at its base, a member stride apart; batches
// beyond 65535 members take one launch per 65535. The 16-byte vectors need
// every member's rows on 16-byte boundaries, so V is chosen from the base
// pointers and the stride together: a (B, 51, 51) float32 batch has odd
// members at 4-byte offsets and runs with V = 1, as its single launch does
// (ny = 51 is not a multiple of 4).

#include "common.cuh"

namespace ns {

constexpr int kK3Rows = 8;      // output rows of a tile
constexpr int kK3Threads = 256;  // 8 rows x 32 vectors

template <typename T>
struct K3Coeffs {
  T dt, dtnu, twodx, twody, dx2, dy2;
};

// The y-advection derivative's form: the corrected axis-1 difference, the
// reference quirk's axis-0 difference over 2dy, or the quirk where 2dx ==
// 2dy, whose quotient is the axis-0 derivative's own (the same operands).
enum K3Quirk { kQuirkOff = 0, kQuirkOn = 1, kQuirkSame = 2 };

// The predictor of field f (0 u, 1 v) at the staged cell q of planes s
// (u, v, u1, v1, each P cells, row pitch SC), in the TPU kernel's
// expression order. x-derivatives along axis 0 (chorin_fd's axis
// convention); under the reference quirk the y-advection derivative reuses
// the axis-0 difference, divided by 2*dy.
template <typename T, int SC, int Q>
__device__ __forceinline__ T k3_fresh(const T* __restrict__ s, int P, int f,
                                      int q, const K3Coeffs<T>& k) {
  const T* fn = s + f * P;
  const T* fn1 = s + (2 + f) * P;
  auto dx_ = [&](const T* g) {
    return div_nz(g[q + SC] - g[q - SC], k.twodx);
  };
  auto dy_ = [&](const T* g, T gx) {
    if constexpr (Q == kQuirkSame) return gx;
    if constexpr (Q == kQuirkOn) return div_nz(g[q + SC] - g[q - SC], k.twody);
    return div_nz(g[q + 1] - g[q - 1], k.twody);
  };
  auto lap = [&](const T* g) {
    return div_nz(g[q + SC] - T(2) * g[q] + g[q - SC], k.dx2) +
           div_nz(g[q + 1] - T(2) * g[q] + g[q - 1], k.dy2);
  };
  const T uc = s[q], vc = s[P + q], uc1 = s[2 * P + q], vc1 = s[3 * P + q];
  const T a = T(1.5), h = T(0.5);
  const T fx = dx_(fn), fx1 = dx_(fn1);
  return fn[q] - k.dt * (a * (uc * fx + vc * dy_(fn, fx)) -
                         h * (uc1 * fx1 + vc1 * dy_(fn1, fx1))) +
         k.dtnu * (a * lap(fn) - h * lap(fn1));
}

// A side's rule in the plan: constant indices only (a runtime index would
// put the plan on the stack).
template <typename T>
__device__ __forceinline__ void side_rule(const EdgePlan& p, int side,
                                          int* kind, T* term) {
  *kind = -1;
  *term = T(0);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m == side) {
      *kind = p.kind[m];
      *term = T(p.term[m]);
    }
  }
}

// The offset of the cell a Neumann BC of `side` reads: left reads row 1,
// right row nx-2, bottom column 1, top column ny-2.
template <int SC>
__device__ __forceinline__ int inner_offset(int side) {
  return side == 0 ? SC : side == 1 ? -SC : side == 2 ? 1 : -1;
}

// The value the BC list leaves on the boundary cell (gi, gj) of field f,
// staged at q, by the edge plan `pl`.
template <typename T, int SC, int Q>
__device__ T k3_boundary(const T* __restrict__ s, int P, int f, int q,
                         int gi, int gj, int nx, int ny, const EdgePlan& pl,
                         const K3Coeffs<T>& k) {
  const T* fn = s + f * P;
  const bool row_edge = gi == 0 || gi == nx - 1;
  const bool col_edge = gj == 0 || gj == ny - 1;
  int kind;
  T term;
  if (row_edge && col_edge) {
    const int c = (gi == 0 ? 0 : 2) + (gj == 0 ? 0 : 1);
    int side = -1;
#pragma unroll
    for (int m = 0; m < 4; ++m) side = c == m ? pl.corner[m] : side;
    if (side < 0) return fn[q];
    side_rule(pl, side, &kind, &term);
    if (kind == 0) return term;
    // the edge cell next to the corner that side's Neumann BC reads lies on
    // the corner's other side, o; its value is o's rule there
    const int qa = q + inner_offset<SC>(side);
    const int o = side <= 1 ? (gj == 0 ? 2 : 3) : (gi == 0 ? 0 : 1);
    int ko;
    T to;
    side_rule(pl, o, &ko, &to);
    T adj;
    if (ko < 0) {
      adj = fn[qa];
    } else if (ko == 0) {
      adj = to;
    } else {
      adj = k3_fresh<T, SC, Q>(s, P, f, qa + inner_offset<SC>(o), k) + to;
    }
    return adj + term;
  }
  const int side = gi == 0 ? 0 : gi == nx - 1 ? 1 : gj == 0 ? 2 : 3;
  side_rule(pl, side, &kind, &term);
  if (kind < 0) return fn[q];
  if (kind == 0) return term;
  return k3_fresh<T, SC, Q>(s, P, f, q + inner_offset<SC>(side), k) + term;
}

// Copy `bytes` (4, 8 or 16) from global to shared memory, asynchronously.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
  }
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// V: elements of a vector along j (16 bytes' worth where the rows allow,
// else 1). A tile is kK3Rows rows x 32 V columns; thread t computes the
// vector t % 32 of tile row t / 32.
template <typename T, int V, int Q>
__global__ void __launch_bounds__(kK3Threads)
momentum_kernel(const T* __restrict__ un, const T* __restrict__ vn,
                const T* __restrict__ un1, const T* __restrict__ vn1,
                T* __restrict__ uo, T* __restrict__ vo, int nx, int ny,
                K3Coeffs<T> k, EdgePlan pu, EdgePlan pv, long long stride) {
  constexpr int TC = 32 * V;           // output columns of a tile
  constexpr int SR = kK3Rows + 2;      // staged rows: one halo row a side
  constexpr int SC = TC + 2 * V;       // staged columns: one vector a side
  constexpr int P = SR * SC;
  constexpr int NV = SC / V;           // staged vectors a row
  __shared__ __align__(16) T s[4 * P];
  // member blockIdx.z of the batch
  const long long member = static_cast<long long>(blockIdx.z) * stride;
  un += member;
  vn += member;
  un1 += member;
  vn1 += member;
  uo += member;
  vo += member;
  // tiles past the grid's last full tile end at its edge
  const int i0 = min(static_cast<int>(blockIdx.y) * kK3Rows,
                     max(nx - kK3Rows, 0));
  const int j0 = min(static_cast<int>(blockIdx.x) * TC, max(ny - TC, 0));
  const T* src[4] = {un, vn, un1, vn1};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    for (int idx = threadIdx.x; idx < SR * NV; idx += kK3Threads) {
      const int r = idx / NV, cv = idx - r * NV;
      const int gi = i0 - 1 + r, gj = j0 - V + cv * V;
      if (gi < 0 || gi >= nx || gj < 0 || gj >= ny) continue;
      cp_async<static_cast<int>(V * sizeof(T))>(s + f * P + r * SC + cv * V,
                              src[f] + static_cast<size_t>(gi) * ny + gj);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int tr = threadIdx.x >> 5, tv = threadIdx.x & 31;
  const int gi = i0 + tr, gj0 = j0 + tv * V;
  if (gi >= nx || gj0 >= ny) return;
  const int q0 = (tr + 1) * SC + V + tv * V;
  Vec<T, V> ou, ov;
  if (gi >= 1 && gi <= nx - 2 && gj0 >= 1 && gj0 + V - 1 <= ny - 2) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      ou.v[e] = k3_fresh<T, SC, Q>(s, P, 0, q0 + e, k);
      ov.v[e] = k3_fresh<T, SC, Q>(s, P, 1, q0 + e, k);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int gj = gj0 + e;
      if (gi >= 1 && gi <= nx - 2 && gj >= 1 && gj <= ny - 2) {
        ou.v[e] = k3_fresh<T, SC, Q>(s, P, 0, q0 + e, k);
        ov.v[e] = k3_fresh<T, SC, Q>(s, P, 1, q0 + e, k);
      } else {
        ou.v[e] = k3_boundary<T, SC, Q>(s, P, 0, q0 + e, gi, gj, nx, ny, pu,
                                        k);
        ov.v[e] = k3_boundary<T, SC, Q>(s, P, 1, q0 + e, gi, gj, nx, ny, pv,
                                        k);
      }
    }
  }
  // V > 1 only where ny % V == 0: a vector never crosses the row's end
  const size_t g = static_cast<size_t>(gi) * ny + gj0;
  *reinterpret_cast<Vec<T, V>*>(uo + g) = ou;
  *reinterpret_cast<Vec<T, V>*>(vo + g) = ov;
}

// the most members one launch takes (gridDim.z)
constexpr int kK3MaxMembers = 65535;

// One launch per kK3MaxMembers members, as the wrapper counts them
// (momentum_kernels.py::K3_MAX_MEMBERS).
template <typename T, int V>
cudaError_t launch_momentum(const T* un, const T* vn, const T* un1,
                            const T* vn1, T* uo, T* vo, int nx, int ny,
                            const K3Coeffs<T>& k, int quirk,
                            const EdgePlan& pu, const EdgePlan& pv, int batch,
                            long long stride, cudaStream_t s) {
  for (int m0 = 0; m0 < batch; m0 += kK3MaxMembers) {
    const long long o = static_cast<long long>(m0) * stride;
    const dim3 grid((ny + 32 * V - 1) / (32 * V),
                    (nx + kK3Rows - 1) / kK3Rows,
                    min(batch - m0, kK3MaxMembers));
    if (!quirk)
      momentum_kernel<T, V, kQuirkOff><<<grid, kK3Threads, 0, s>>>(
          un + o, vn + o, un1 + o, vn1 + o, uo + o, vo + o, nx, ny, k, pu, pv,
          stride);
    else if (k.twodx == k.twody)
      momentum_kernel<T, V, kQuirkSame><<<grid, kK3Threads, 0, s>>>(
          un + o, vn + o, un1 + o, vn1 + o, uo + o, vo + o, nx, ny, k, pu, pv,
          stride);
    else
      momentum_kernel<T, V, kQuirkOn><<<grid, kK3Threads, 0, s>>>(
          un + o, vn + o, un1 + o, vn1 + o, uo + o, vo + o, nx, ny, k, pu, pv,
          stride);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// plan_spec: the edge plans of u_bc and v_bc, 12 doubles each (as K2's).
// batch members, `stride` elements apart (batch 1: the single call).
template <typename T>
int momentum_explicit(const void* un, const void* vn, const void* un1,
                      const void* vn1, void* uo, void* vo, int nx, int ny,
                      double dt, double dtnu, double twodx, double twody,
                      double dx2, double dy2, int quirk,
                      const double* plan_spec, int batch, long long stride,
                      void* stream) {
  if (nx < 3 || ny < 3 || batch < 1 ||
      (batch > 1 && stride < static_cast<long long>(nx) * ny))
    return cudaErrorInvalidValue;
  EdgePlan pu, pv;
  cudaError_t e = make_plan(plan_spec, &pu);
  if (e == cudaSuccess) e = make_plan(plan_spec + 12, &pv);
  if (e != cudaSuccess) return e;
  const K3Coeffs<T> k{T(dt), T(dtnu), T(twodx), T(twody), T(dx2), T(dy2)};
  const T* a = static_cast<const T*>(un);
  const T* b = static_cast<const T*>(vn);
  const T* c = static_cast<const T*>(un1);
  const T* d = static_cast<const T*>(vn1);
  T* ou = static_cast<T*>(uo);
  T* ov = static_cast<T*>(vo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors where every row of every member starts on a 16-byte
  // boundary: the bases, and the member stride in bytes
  constexpr int V = 16 / sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(ou) |
                        reinterpret_cast<uintptr_t>(ov) |
                        (batch > 1 ? static_cast<uintptr_t>(stride) * sizeof(T)
                                   : 0);
  if (ny % V == 0 && any % 16 == 0)
    return launch_momentum<T, V>(a, b, c, d, ou, ov, nx, ny, k, quirk, pu, pv,
                                 batch, stride, s);
  return launch_momentum<T, 1>(a, b, c, d, ou, ov, nx, ny, k, quirk, pu, pv,
                               batch, stride, s);
}

}  // namespace ns

extern "C" {

#define NS_MOMENTUM(SUFFIX, T)                                                \
  int ns_momentum_explicit_##SUFFIX(                                          \
      const void* un, const void* vn, const void* un1, const void* vn1,      \
      void* uo, void* vo, int nx, int ny, double dt, double dtnu,            \
      double twodx, double twody, double dx2, double dy2, int quirk,         \
      const double* plan_spec, int batch, long long stride, void* stream) {  \
    return ns::momentum_explicit<T>(un, vn, un1, vn1, uo, vo, nx, ny, dt,    \
                                    dtnu, twodx, twody, dx2, dy2, quirk,     \
                                    plan_spec, batch, stride, stream);       \
  }
NS_MOMENTUM(f32, float)
NS_MOMENTUM(f64, double)

}  // extern "C"
