// Fused 3D compact-transform kernels for Hopper (sm_90a), float32: K6, K7
// and K8 of the port.
//
// K6 fused_zy_forward replaces ns_tpu/ops/pallas/transform3d_kernels.py
//                     ::fused_zy_forward (body _fwd_kernel): the z-DFT and
//                     then the y-DFT of the compact forward transform.
// K7 fused_yz_inverse replaces ::fused_yz_inverse (body _inv_kernel): the
//                     y-inverse and then the z-unfold, real part only.
// K8 fused_lamb       replaces ::fused_lamb (body _lamb_kernel): the whole
//                     physical leg of the nonlinear term, yz-inverse of six
//                     fields (u, omega), the cross product u x omega, and
//                     the zy-forward of the three products.
//
// Layouts (row-major, complex as interleaved float2 = torch complex64):
//   physical w (B, nx, ny, nz) float; spectral a (B, nx, Ry, Kzc) float2;
//   Fy (Ry, ny), Fyi (ny, Ry), Bz (Kzc, nz), FzT (nz, Kzc) = Fz_t^T.
// The x-stage contracts across x-rows and stays the caller's GEMM.
//
// What bounds them on the H100. At 256^3 one (ny, nz) float slab is 256 KB,
// more than a block's 227 KB of shared memory, and one x-row of K8's input
// (six Ry x Kzc complex fields) is 706 KB. So every kernel walks an x-row
// in tiles of kTY = 16 y-rows: a tile's physical rows (16 x nz floats, 16 KB)
// and its z-stage spectrum (16 x Kzc complex, 11 KB) live in shared memory,
// and the y-stage either needs only the tile's rows (the inverse: y is an
// output index) or accumulates over tiles (the forward: y is contracted).
// Per x-row K8 does ~470 MFLOP against ~1 MB of L2 reads (the six spectral
// rows per tile, plus the DFT tables, which stay L2-resident), so the
// kernels are bound by FMA issue, not by bytes: each stage is a register-
// blocked GEMM on CUDA-core FMAs (a work item is one output column and a
// block of rows whose sums stay in registers, the shared operand broadcast
// from shared memory; the rows per item are chosen so that the items of a
// stage fill the block). Tensor cores (wgmma with 3xTF32 split for fp32
// accuracy), TMA and clusters are later work.
//
//   K6: one block per (b, x). It loops over the y-tiles: z-stage of the
//       tile into shared memory, then the tile's share of the y-stage added
//       into the (Ry, Kzc) output, which stays in shared memory for the
//       whole row (118 KB at 256^3) and is written once. The z-to-y
//       intermediate never leaves the chip.
//   K7: one block per (b, x, y-tile). The y-inverse of the tile's rows
//       contracts all Ry, so no sum crosses blocks; then the z-unfold
//       Re(t) Bz_re - Im(t) Bz_im writes the tile's physical rows.
//   K8: two launches. The first, one block per (x, y-tile), runs the
//       y-inverse of the six fields, the z-unfold, the cross product and
//       the z-forward of the three products, all in shared memory, and
//       writes only the z-reduced products S (3, nx, ny, Kzc) complex. The
//       second, one block per (component, x, 16 Ry rows), is the y-forward
//       GEMM Fy @ S. No physical field (B, nx, ny, nz) is ever written to
//       global memory, and every sum is taken inside one thread in a fixed
//       order: no atomics, the result is deterministic.

#include "common.cuh"

namespace ns {
namespace t3d {

constexpr int kTY = 16;  // y-rows per tile (K6, K7, K8 first launch)
constexpr int kBT = 16;  // Ry rows per block of K8's y-forward launch
constexpr int kRB = 4;   // y-rows per register block of K8's z-unfold

struct Dims {
  int nx, ny, nz, ry, kzc;
};

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// Fyi rows y0 .. y0+kTY-1 into shared memory as [kTY][ry]; rows past ny are
// zero, so every later stage may run all kTY rows.
__device__ __forceinline__ void load_fyi_tile(const float2* __restrict__ fyi,
                                              float2* fyi_s, int y0,
                                              const Dims& d) {
  for (int i = threadIdx.x; i < kTY * d.ry; i += blockDim.x) {
    const int r = i / d.ry, b = i - r * d.ry;
    const int y = y0 + r;
    fyi_s[i] = y < d.ny ? fyi[static_cast<size_t>(y) * d.ry + b]
                        : make_float2(0.f, 0.f);
  }
}

// y-inverse of nf fields for one tile: T[f][r][k] = sum_b Fyi[y0+r][b] a_f[b][k]
// with a_f = a + f * fstride, an (ry, kzc) complex row. One work item is
// one (f, k) column and RPI rows, whose sums stay in registers; RPI sets
// how many items there are to spread over the block.
template <int RPI>
__device__ __forceinline__ void y_inverse_tile(const float2* __restrict__ a,
                                               size_t fstride, int nf,
                                               const float2* fyi_s,
                                               float2* t_s, const Dims& d) {
  constexpr int G = kTY / RPI;
  for (int it = threadIdx.x; it < nf * G * d.kzc; it += blockDim.x) {
    const int fg = it / d.kzc, k = it - fg * d.kzc;
    const int f = fg / G, r0 = (fg - f * G) * RPI;
    const float2* col = a + f * fstride + k;
    const float2* fy = fyi_s + r0 * d.ry;
    float2 acc[RPI];
#pragma unroll
    for (int r = 0; r < RPI; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int b = 0; b < d.ry; ++b) {
      const float2 v = __ldg(col + static_cast<size_t>(b) * d.kzc);
#pragma unroll
      for (int r = 0; r < RPI; ++r) cmac(acc[r], fy[r * d.ry + b], v);
    }
#pragma unroll
    for (int r = 0; r < RPI; ++r)
      t_s[(f * kTY + r0 + r) * d.kzc + k] = acc[r];
  }
}

// z-forward of nc real row sets: out[c][r][k] = sum_z rows[c][r][z] FzT[z][k]
// for rows [nc][kTY][nz] in shared memory; out row r of component c at
// out + c * cstride + r * kzc, rows r < nrows stored. Work items as in
// y_inverse_tile: one (c, k) column and RPI rows.
template <int RPI>
__device__ __forceinline__ void z_forward_tile(const float* rows_s, int nc,
                                               const float2* __restrict__ fzt,
                                               float2* out, size_t cstride,
                                               int nrows, const Dims& d) {
  constexpr int G = kTY / RPI;
  for (int it = threadIdx.x; it < nc * G * d.kzc; it += blockDim.x) {
    const int cg = it / d.kzc, k = it - cg * d.kzc;
    const int c = cg / G, r0 = (cg - c * G) * RPI;
    const float* rows = rows_s + (c * kTY + r0) * d.nz;
    float2 acc[RPI];
#pragma unroll
    for (int r = 0; r < RPI; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int z = 0; z < d.nz; ++z) {
      const float2 f = __ldg(fzt + static_cast<size_t>(z) * d.kzc + k);
#pragma unroll
      for (int r = 0; r < RPI; ++r) {
        const float l = rows[r * d.nz + z];
        acc[r].x = fmaf(l, f.x, acc[r].x);
        acc[r].y = fmaf(l, f.y, acc[r].y);
      }
    }
    float2* o = out + c * cstride + k;
#pragma unroll
    for (int r = 0; r < RPI; ++r)
      if (r0 + r < nrows) o[static_cast<size_t>(r0 + r) * d.kzc] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// K6: (B*nx) blocks of 512 threads.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(512)
zy_forward_kernel(const float* __restrict__ w, const float2* __restrict__ fzt,
                  const float2* __restrict__ fy, float2* __restrict__ out,
                  Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_out = d.ry * d.kzc;
  float2* o_s = reinterpret_cast<float2*>(smem);    // [ry][kzc]
  float2* s_s = o_s + n_out;                         // [kTY][kzc]
  float* w_s = reinterpret_cast<float*>(s_s + kTY * d.kzc);  // [kTY][nz]
  const size_t slab = blockIdx.x;
  const float* wx = w + slab * d.ny * d.nz;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x)
    o_s[i] = make_float2(0.f, 0.f);
  for (int y0 = 0; y0 < d.ny; y0 += kTY) {
    const int rows = min(kTY, d.ny - y0);
    // the previous tile's z-stage read w_s before the last barrier
    for (int i = threadIdx.x; i < kTY * d.nz; i += blockDim.x)
      w_s[i] = i < rows * d.nz ? wx[static_cast<size_t>(y0) * d.nz + i] : 0.f;
    __syncthreads();
    z_forward_tile<4>(w_s, 1, fzt, s_s, 0, kTY, d);
    __syncthreads();
    // y-stage share of this tile; each thread owns fixed outputs
    for (int it = threadIdx.x; it < n_out; it += blockDim.x) {
      const int b = it / d.kzc, k = it - b * d.kzc;
      const float2* fyr = fy + static_cast<size_t>(b) * d.ny + y0;
      float2 acc = o_s[it];
      for (int r = 0; r < rows; ++r) cmac(acc, __ldg(fyr + r), s_s[r * d.kzc + k]);
      o_s[it] = acc;
    }
  }
  __syncthreads();
  float2* ox = out + slab * n_out;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) ox[i] = o_s[i];
}

// ---------------------------------------------------------------------------
// K7: grid (B*nx, ceil(ny/kTY)) of 512 threads.
// ---------------------------------------------------------------------------
constexpr int kUnfoldRows = 8;  // y-rows per work item of K7's z-unfold

__global__ void __launch_bounds__(512)
yz_inverse_kernel(const float2* __restrict__ a, const float2* __restrict__ fyi,
                  const float2* __restrict__ bz, float* __restrict__ out,
                  Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* fyi_s = reinterpret_cast<float2*>(smem);  // [kTY][ry]
  float2* t_s = fyi_s + kTY * d.ry;                 // [kTY][kzc]
  const size_t slab = blockIdx.x;
  const int y0 = blockIdx.y * kTY;
  const int rows = min(kTY, d.ny - y0);
  load_fyi_tile(fyi, fyi_s, y0, d);
  __syncthreads();
  y_inverse_tile<4>(a + slab * d.ry * d.kzc, 0, 1, fyi_s, t_s, d);
  __syncthreads();
  float* ox = out + (slab * d.ny + y0) * d.nz;
  constexpr int G = kTY / kUnfoldRows;
  for (int it = threadIdx.x; it < G * d.nz; it += blockDim.x) {
    const int g = it / d.nz, z = it - g * d.nz;
    const float2* t = t_s + g * kUnfoldRows * d.kzc;
    float acc[kUnfoldRows];
#pragma unroll
    for (int r = 0; r < kUnfoldRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < d.kzc; ++k) {
      const float2 b = __ldg(bz + static_cast<size_t>(k) * d.nz + z);
#pragma unroll
      for (int r = 0; r < kUnfoldRows; ++r) {
        const float2 tv = t[r * d.kzc + k];
        acc[r] = fmaf(tv.x, b.x, acc[r]);
        acc[r] = fmaf(-tv.y, b.y, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kUnfoldRows; ++r) {
      const int row = g * kUnfoldRows + r;
      if (row < rows) ox[static_cast<size_t>(row) * d.nz + z] = acc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// K8, first launch: grid (nx, ceil(ny/kTY)), one thread per (field, Kzc
// column) of the y-inverse up to kPhysThreads. Writes the z-forward of the
// tile's three products into s (3, nx, ny, kzc).
// ---------------------------------------------------------------------------
constexpr int kPhysThreads = 576;

__global__ void __launch_bounds__(kPhysThreads)
lamb_phys_kernel(const float2* __restrict__ a6, const float2* __restrict__ fyi,
                 const float2* __restrict__ bz, const float2* __restrict__ fzt,
                 float2* __restrict__ s, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* fyi_s = reinterpret_cast<float2*>(smem);       // [kTY][ry]
  float2* t_s = fyi_s + kTY * d.ry;                      // [6][kTY][kzc]
  float* l_s = reinterpret_cast<float*>(t_s + 6 * kTY * d.kzc);  // [3][kTY][nz]
  const int x = blockIdx.x;
  const int y0 = blockIdx.y * kTY;
  const int rows = min(kTY, d.ny - y0);
  const size_t spec = static_cast<size_t>(d.ry) * d.kzc;
  load_fyi_tile(fyi, fyi_s, y0, d);
  __syncthreads();
  y_inverse_tile<kTY>(a6 + x * spec, d.nx * spec, 6, fyi_s, t_s, d);
  __syncthreads();
  // z-unfold of the six fields and the cross product; a work item is one
  // z column and kRB rows
  for (int it = threadIdx.x; it < (kTY / kRB) * d.nz; it += blockDim.x) {
    const int g = it / d.nz, z = it - g * d.nz, r0 = g * kRB;
    float acc[6][kRB];
#pragma unroll
    for (int f = 0; f < 6; ++f)
#pragma unroll
      for (int r = 0; r < kRB; ++r) acc[f][r] = 0.f;
    for (int k = 0; k < d.kzc; ++k) {
      const float2 b = __ldg(bz + static_cast<size_t>(k) * d.nz + z);
#pragma unroll
      for (int f = 0; f < 6; ++f)
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          const float2 t = t_s[(f * kTY + r0 + r) * d.kzc + k];
          acc[f][r] = fmaf(t.x, b.x, acc[f][r]);
          acc[f][r] = fmaf(-t.y, b.y, acc[f][r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const float u1 = acc[0][r], u2 = acc[1][r], u3 = acc[2][r];
      const float w1 = acc[3][r], w2 = acc[4][r], w3 = acc[5][r];
      const int row = (r0 + r) * d.nz + z;
      l_s[row] = u2 * w3 - u3 * w2;
      l_s[kTY * d.nz + row] = u3 * w1 - u1 * w3;
      l_s[2 * kTY * d.nz + row] = u1 * w2 - u2 * w1;
    }
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(d.ny) * d.kzc;
  z_forward_tile<kTY / 2>(l_s, 3, fzt,
                          s + x * plane + static_cast<size_t>(y0) * d.kzc,
                          d.nx * plane, rows, d);
}

// ---------------------------------------------------------------------------
// K8, second launch: grid (3*nx, ceil(ry/kBT)), one Kzc column per thread:
// out[c][x][b][k] = sum_y Fy[b][y] s[c][x][y][k].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
lamb_yfwd_kernel(const float2* __restrict__ s, const float2* __restrict__ fy,
                 float2* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* fy_s = reinterpret_cast<float2*>(smem);  // [kBT][ny]
  const size_t row = blockIdx.x;                   // c * nx + x
  const int b0 = blockIdx.y * kBT;
  const int brows = min(kBT, d.ry - b0);
  for (int i = threadIdx.x; i < kBT * d.ny; i += blockDim.x) {
    const int r = i / d.ny;
    fy_s[i] = r < brows ? fy[static_cast<size_t>(b0) * d.ny + i]
                        : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* sx = s + row * d.ny * d.kzc;
  float2* ox = out + (row * d.ry + b0) * d.kzc;
  for (int k = threadIdx.x; k < d.kzc; k += blockDim.x) {
    float2 acc[kBT];
#pragma unroll
    for (int r = 0; r < kBT; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int y = 0; y < d.ny; ++y) {
      const float2 v = __ldg(sx + static_cast<size_t>(y) * d.kzc + k);
#pragma unroll
      for (int r = 0; r < kBT; ++r) cmac(acc[r], fy_s[r * d.ny + y], v);
    }
#pragma unroll
    for (int r = 0; r < kBT; ++r)
      if (r < brows) ox[static_cast<size_t>(r) * d.kzc + k] = acc[r];
  }
}

// Shared-memory bytes of each kernel; the wrappers' fit check
// (ops/kernels/transform3d_kernels.py::smem_bytes) mirrors these.
inline size_t smem_zy_forward(const Dims& d) {
  return (static_cast<size_t>(d.ry) * d.kzc + kTY * d.kzc) * sizeof(float2) +
         static_cast<size_t>(kTY) * d.nz * sizeof(float);
}
inline size_t smem_yz_inverse(const Dims& d) {
  return static_cast<size_t>(kTY) * (d.ry + d.kzc) * sizeof(float2);
}
inline size_t smem_lamb_phys(const Dims& d) {
  return static_cast<size_t>(kTY) * (d.ry + 6 * d.kzc) * sizeof(float2) +
         static_cast<size_t>(3) * kTY * d.nz * sizeof(float);
}
inline size_t smem_lamb_yfwd(const Dims& d) {
  return static_cast<size_t>(kBT) * d.ny * sizeof(float2);
}

// the warp multiple covering `items`, within [lo, hi]
inline int block_threads(int items, int lo, int hi) {
  const int t = (items + 31) / 32 * 32;
  return t < lo ? lo : (t > hi ? hi : t);
}

}  // namespace t3d
}  // namespace ns

extern "C" {

int ns_fused_zy_forward_f32(const void* w, const void* fzt, const void* fy,
                            void* out, int B, int nx, int ny, int nz, int ry,
                            int kzc, void* stream) {
  using namespace ns::t3d;
  const Dims d{nx, ny, nz, ry, kzc};
  const size_t smem = smem_zy_forward(d);
  cudaError_t e = ns::allow_smem(zy_forward_kernel, smem);
  if (e != cudaSuccess) return e;
  zy_forward_kernel<<<B * nx, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float2*>(fzt),
      static_cast<const float2*>(fy), static_cast<float2*>(out), d);
  return cudaGetLastError();
}

int ns_fused_yz_inverse_f32(const void* a, const void* fyi, const void* bz,
                            void* out, int B, int nx, int ny, int nz, int ry,
                            int kzc, void* stream) {
  using namespace ns::t3d;
  const Dims d{nx, ny, nz, ry, kzc};
  const size_t smem = smem_yz_inverse(d);
  cudaError_t e = ns::allow_smem(yz_inverse_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * nx, (ny + kTY - 1) / kTY);
  yz_inverse_kernel<<<grid, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(fyi),
      static_cast<const float2*>(bz), static_cast<float*>(out), d);
  return cudaGetLastError();
}

int ns_fused_lamb_f32(const void* a6, const void* fyi, const void* bz,
                      const void* fzt, const void* fy, void* scratch,
                      void* out, int nx, int ny, int nz, int ry, int kzc,
                      void* stream) {
  using namespace ns::t3d;
  const Dims d{nx, ny, nz, ry, kzc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = smem_lamb_phys(d), smem2 = smem_lamb_yfwd(d);
  cudaError_t e = ns::allow_smem(lamb_phys_kernel, smem1);
  if (e != cudaSuccess) return e;
  e = ns::allow_smem(lamb_yfwd_kernel, smem2);
  if (e != cudaSuccess) return e;
  lamb_phys_kernel<<<dim3(nx, (ny + kTY - 1) / kTY),
                     block_threads(6 * kzc, 256, kPhysThreads), smem1, s>>>(
      static_cast<const float2*>(a6), static_cast<const float2*>(fyi),
      static_cast<const float2*>(bz), static_cast<const float2*>(fzt),
      static_cast<float2*>(scratch), d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lamb_yfwd_kernel<<<dim3(3 * nx, (ry + kBT - 1) / kBT),
                     block_threads(kzc, 32, 256), smem2, s>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(fy),
      static_cast<float2*>(out), d);
  return cudaGetLastError();
}

}  // extern "C"
