// K3 momentum_explicit_fused for Hopper (sm_90a): the chorin_fd explicit
// predictor (AB2 advection + AB2 diffusion of u and v) followed by the u/v
// BC edge writes. Replaces ns_tpu/ops/pallas/momentum_kernels.py
// ::momentum_explicit_fused_pallas (entry ::momentum_explicit_fused_any).
//
// What bounds it on the H100: bytes. Per cell it reads four fields and
// writes two (6 * itemsize bytes) for ~60 FLOPs, far below the ridge point,
// so the design reads each input once and keeps the stencil neighbours in
// L1/L2 rather than staging halos: one thread computes one cell of both u*
// and v*, neighbouring threads touch neighbouring addresses, and no
// intermediate field goes to device memory.
//
// The BC edge writes must follow the interior update in list order, and a
// Neumann edge reads the UPDATED inner neighbour, which another block may
// have written. So the edges are a second, small launch: two blocks (one
// for u_bc, one for v_bc; the lists touch different fields) that apply
// their BCs edge by edge with a __syncthreads between edges.

#include "common.cuh"

namespace ns {

template <typename T>
__global__ void __launch_bounds__(256)
momentum_interior_kernel(const T* __restrict__ un, const T* __restrict__ vn,
                         const T* __restrict__ un1, const T* __restrict__ vn1,
                         T* __restrict__ uo, T* __restrict__ vo, int nx,
                         int ny, T dt, T dtnu, T twodx, T twody, T dx2, T dy2,
                         int quirk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int k = i * ny + j;
  if (i == 0 || i == nx - 1 || j == 0 || j == ny - 1) {
    uo[k] = un[k];
    vo[k] = vn[k];
    return;
  }
  // x-derivatives along axis 0 (chorin_fd's axis convention). Under the
  // reference quirk the y-advection derivative reuses the axis-0
  // difference, divided by 2*dy.
  auto dx_ = [&](const T* f) { return (f[k + ny] - f[k - ny]) / twodx; };
  auto dy_ = [&](const T* f) {
    return quirk ? (f[k + ny] - f[k - ny]) / twody
                 : (f[k + 1] - f[k - 1]) / twody;
  };
  auto lap = [&](const T* f) {
    return (f[k + ny] - T(2) * f[k] + f[k - ny]) / dx2 +
           (f[k + 1] - T(2) * f[k] + f[k - 1]) / dy2;
  };
  const T uc = un[k], vc = vn[k], uc1 = un1[k], vc1 = vn1[k];
  const T a = T(1.5), h = T(0.5);
  uo[k] = uc - dt * (a * (uc * dx_(un) + vc * dy_(un)) -
                     h * (uc1 * dx_(un1) + vc1 * dy_(un1))) +
          dtnu * (a * lap(un) - h * lap(un1));
  vo[k] = vc - dt * (a * (uc * dx_(vn) + vc * dy_(vn)) -
                     h * (uc1 * dx_(vn1) + vc1 * dy_(vn1))) +
          dtnu * (a * lap(vn) - h * lap(vn1));
}

template <typename T>
__global__ void __launch_bounds__(1024)
momentum_bc_kernel(T* __restrict__ uo, T* __restrict__ vo, int nx, int ny,
                   BCList ubc, BCList vbc) {
  T* a = blockIdx.x == 0 ? uo : vo;
  const BCList& bcs = blockIdx.x == 0 ? ubc : vbc;
  for (int q = 0; q < bcs.n; ++q) {
    apply_bc_edge(a, nx, ny, bcs.kind[q], bcs.side[q], T(bcs.term[q]),
                  threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

template <typename T>
int momentum_explicit(const void* un, const void* vn, const void* un1,
                      const void* vn1, void* uo, void* vo, int nx, int ny,
                      double dt, double dtnu, double twodx, double twody,
                      double dx2, double dy2, int quirk, int n_ubc,
                      const double* ubc_spec, int n_vbc,
                      const double* vbc_spec, void* stream) {
  BCList ubc, vbc;
  cudaError_t e = make_bcs(n_ubc, ubc_spec, &ubc);
  if (e != cudaSuccess) return e;
  e = make_bcs(n_vbc, vbc_spec, &vbc);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y);
  momentum_interior_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(un), static_cast<const T*>(vn),
      static_cast<const T*>(un1), static_cast<const T*>(vn1),
      static_cast<T*>(uo), static_cast<T*>(vo), nx, ny, T(dt), T(dtnu),
      T(twodx), T(twody), T(dx2), T(dy2), quirk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  momentum_bc_kernel<T><<<2, 1024, 0, s>>>(static_cast<T*>(uo),
                                           static_cast<T*>(vo), nx, ny, ubc,
                                           vbc);
  return cudaGetLastError();
}

}  // namespace ns

extern "C" {

#define NS_MOMENTUM(SUFFIX, T)                                                \
  int ns_momentum_explicit_##SUFFIX(                                          \
      const void* un, const void* vn, const void* un1, const void* vn1,      \
      void* uo, void* vo, int nx, int ny, double dt, double dtnu,            \
      double twodx, double twody, double dx2, double dy2, int quirk,         \
      int n_ubc, const double* ubc_spec, int n_vbc, const double* vbc_spec,  \
      void* stream) {                                                        \
    return ns::momentum_explicit<T>(un, vn, un1, vn1, uo, vo, nx, ny, dt,    \
                                    dtnu, twodx, twody, dx2, dy2, quirk,     \
                                    n_ubc, ubc_spec, n_vbc, vbc_spec,        \
                                    stream);                                 \
  }
NS_MOMENTUM(f32, float)
NS_MOMENTUM(f64, double)

}  // extern "C"
