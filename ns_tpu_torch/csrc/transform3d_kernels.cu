// Fused 3D compact-transform kernels for Hopper (sm_90a), float32: K6, K7
// and K8 of the port. Each has two routes, by the JAX kernels' precision
// contract (_prec): at 'default' (the TPU's DEFAULT: bf16 GEMM operands,
// fp32 accumulation and result) tensor-core kernels (mma.sync m16n8k16
// bf16); at 'high' and 'highest' (both HIGHEST there) fp32-class kernels
// on the TF32 tensor cores with a 3xTF32 split (mma.sync m16n8k8 tf32,
// three products each: note further down).
//
// K6 fused_zy_forward replaces ns_tpu/ops/pallas/transform3d_kernels.py
//                     ::fused_zy_forward (body _fwd_kernel): the z-DFT and
//                     then the y-DFT of the compact forward transform
//                     (zy_forward_bf16_kernel; zy_forward_tf32_kernel).
//                     Bound at 256^3, B=3: 201 MB of w read and 90 MB
//                     written, 0.087 ms at 3.35 TB/s; 40.4 GFLOP, 0.041 ms
//                     on bf16 tensor cores, 0.60 ms on fp32 FMAs, and 0.245
//                     ms as 3xTF32 (3 x 40.4 GFLOP at 495 TFLOP/s). So the
//                     bf16 kernel is bound by bytes and is built to stream
//                     w once per column chunk with the copies overlapped
//                     (its own note below); the 3xTF32 one is bound by its
//                     tensor-core products and keeps them fed from shared
//                     memory and registers (its note below).
// K7 fused_yz_inverse replaces ::fused_yz_inverse (body _inv_kernel): the
//                     y-inverse and then the z-unfold, real part only
//                     (yz_inverse_bf16_kernel; yz_inverse_tf32_kernel).
//                     Bound at 256^3, B=1: 30 MB of spectrum read and 67 MB
//                     written, 0.029 ms; 13.5 GFLOP, 0.014 ms on bf16
//                     tensor cores, 0.20 ms on fp32 FMAs, 0.082 ms as
//                     3xTF32 (bound by operations). The bf16 kernel reads
//                     each slab's spectrum once per 32-row y-tile from L2,
//                     the 3xTF32 one once per 128-row y-tile, and both
//                     write the physical rows once; both GEMMs run on the
//                     tensor cores (notes further down).
// K8 fused_lamb       replaces ::fused_lamb (body _lamb_kernel): the whole
//                     physical leg of the nonlinear term, yz-inverse of six
//                     fields (u, omega), the cross product u x omega, and
//                     the zy-forward of the three products (lamb_phys_bf16
//                     + lamb_yfwd_bf16; lamb_phys_tf32 + lamb_yfwd_tf32).
//                     Bound at 256^3: 271 MB in and out, 0.081 ms; 121
//                     GFLOP, 0.12 ms on bf16 tensor cores, 0.735 ms as
//                     3xTF32, 1.81 ms on fp32 FMAs (so bound by operations).
//                     Both pairs run all four stages on the tensor cores; no
//                     physical field reaches device memory, only the
//                     z-reduced products (68 MB in bf16, 302 MB as 3xTF32
//                     planes at 256^3).
//
// Layouts (row-major, complex as interleaved float2 = torch complex64):
//   physical w (B, nx, ny, nz) float; spectral a (B, nx, Ry, Kzc) float2;
//   Fy (Ry, ny), Fyi (ny, Ry), Bz (Kzc, nz), FzT (nz, Kzc) = Fz_t^T. The
//   kernels take their tables as the wrappers lay them out
//   (ops/kernels/transform3d_kernels.py: bf16_tables, inverse_tables and
//   lamb_tables in bf16; tf32_tables and inverse_tf32_tables split into
//   tf32 planes).
// The x-stage contracts across x-rows and stays the caller's GEMM.

#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace ns {
namespace t3d {

// ---------------------------------------------------------------------------
// K6 at 'default' on the tensor cores: grid (nchunks * rparts, B*nx) of
// kBThreads, one block per (Kzc chunk, part of the Ry rows, slab).
//
// The TPU DEFAULT's rounding points: w and Fz_t rounded to bf16 (RNE), the
// z-stage accumulated in fp32, t rounded to bf16 once, the y-stage one
// real GEMM on the complex block form
//     [out_re; out_im] = [[Fy_re, -Fy_im], [Fy_im, Fy_re]] @ [t_re; t_im]
// with an fp32 accumulator, the output fp32 complex.
//
// A block takes kBKC columns k of the output, so it needs only the z-stage
// columns (re and im) of those k: the z-stage is split between the chunks,
// not repeated, and only w is read once per chunk (the chunks of a slab are
// neighbouring blocks, so the second read mostly hits L2). It walks the
// slab in y-tiles of kBTY rows: w's fp32 rows arrive by cp.async into one
// of two buffers while the other is computed; the z-stage (mma.sync
// m16n8k16 bf16, A built from the fp32 rows with the bf16 rounding, B by
// ldmatrix from the chunk's Fz rows resident in shared memory) writes the
// tile's t as bf16; the y-stage reads t by ldmatrix.trans and takes its A
// straight from global memory in mma fragment order, one coalesced 16-byte
// load per lane and fragment (the wrapper lays the table out so). Each warp
// owns one 16-row tile r of Ry, as an out_re and an out_im m-tile of the
// block matrix: both are made of the same Fy_re and Fy_im fragments (re:
// Fy_re, -Fy_im; im: Fy_im, Fy_re; -Fy_im by flipping the sign bits), so
// the warp loads each once and the table holds Fy once, not the block
// matrix. A is not shared between warps and never goes through shared
// memory; its loads are issued at the top of the tile, so that their L2
// latency hides behind the z-stage. The (2 Ry, kBKC) output accumulates
// in registers over the whole slab (48 fp32 a thread); beyond kBWarps row
// tiles (Ry > 192) the rows are split over more blocks (rparts), each
// repeating the z-stage. Every shape is zero-padded inside shared memory
// and the tables (nz to 16, Ry to 16, y to kBTY, Kzc to kBKC) and the
// ragged edges are masked at the store.
// ---------------------------------------------------------------------------
constexpr int kBTY = 32;              // y-rows per tile
constexpr int kBKC = 48;              // output columns k per block
constexpr int kBN1 = 2 * kBKC;        // z-stage columns per block (re | im)
constexpr int kBWarps = 12;
constexpr int kBThreads = 32 * kBWarps;
constexpr int kBTS = kBN1 + 8;        // t tile's row stride (bf16 values)

struct BfDims {
  int ny, nz, ry, kzc;
  int nzp;      // nz rounded up to 16 (the MMA depth)
  int rt;       // 16-row tiles of Ry, ceil(ry / 16)
  int nchunks;  // ceil(kzc / kBKC)
  int rparts;   // ceil(rt / kBWarps)
  int nyt;      // ceil(ny / kBTY)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0 zero-fills the destination) from global to shared
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += A B for one m16n8k16 tile: bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (RNE), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// w rows y0 .. y0+kBTY-1 of one slab into wbuf [kBTY][nzp + 8] as fp32;
// rows past ny and columns past nz are zero-filled
__device__ __forceinline__ void load_w_tile(const float* __restrict__ wx,
                                            float* wbuf, int y0,
                                            const BfDims& d, int vec16) {
  const int nzs = d.nzp + 8;
  if (vec16) {  // nz % 4 == 0 and w 16-byte aligned: whole 16-byte chunks
    const int cpr = d.nzp >> 2;
    for (int i = threadIdx.x; i < kBTY * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) << 2;
      const int y = y0 + r;
      const bool ok = y < d.ny && c < d.nz;
      cp_async16(smem_u32(wbuf + r * nzs + c),
                 ok ? wx + static_cast<size_t>(y) * d.nz + c : wx,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBTY * d.nzp; i += blockDim.x) {
      const int r = i / d.nzp, c = i - r * d.nzp;
      const int y = y0 + r;
      const bool ok = y < d.ny && c < d.nz;
      cp_async4(smem_u32(wbuf + r * nzs + c),
                ok ? wx + static_cast<size_t>(y) * d.nz + c : wx, ok ? 4 : 0);
    }
  }
}

// -x for two packed bf16 values
__device__ __forceinline__ unsigned neg_bf16x2(unsigned x) {
  return x ^ 0x80008000u;
}
__device__ __forceinline__ uint4 neg_bf16x8(uint4 v) {
  return make_uint4(neg_bf16x2(v.x), neg_bf16x2(v.y), neg_bf16x2(v.z),
                    neg_bf16x2(v.w));
}

// fzb (nchunks, kBN1, nzp) bf16: row n < kBKC of chunk c is Re Fz_t[c kBKC
// + n, :], row kBKC + n its Im, zero past Kzc and nz. afrag: Fy_t in mma A
// fragment order, (nyt, rt, 2, 2, 32) uint4: entry (j, r, h, q, lane) holds
// the 8 bf16 of lane's fragment of the 16x16 tile of Fy_re (q = 0) or
// Fy_im (q = 1) at rows 16 r .., columns y = j kBTY + 16 h ...

// The y-stage's A fragments of y-tile j for the warp's row tile yr
// (F[h][q]: y-half h, Fy_re or Fy_im), issued early so that their L2
// latency hides behind the work before y_stage_mma.
__device__ __forceinline__ void y_stage_frags(uint4 (&F)[2][2],
                                              const uint4* __restrict__ afrag,
                                              int j, int yr, const BfDims& d) {
  const uint4* af =
      afrag + (static_cast<size_t>(j) * d.rt + yr) * 4 * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < 4; ++i) F[i >> 1][i & 1] = __ldg(af + i * 32);
}

// acc += A(j) [t_re; t_im] for one y-tile: t is [kBTY][kBTS] bf16 in shared
// memory, columns n < kBKC its re part and kBKC + n its im part; yb is the
// lane's ldmatrix.trans address of the tile (matrix q: k half q & 1, n-tile
// q >> 1 of a pair). acc[0] holds the out_re rows, acc[1] the out_im rows
// of the warp's row tile.
__device__ __forceinline__ void y_stage_mma(float (&acc)[2][kBKC / 8][4],
                                            const uint4 (&F)[2][2],
                                            unsigned yb) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // k-step s: t_re rows (s < 2) or t_im rows, y-half s & 1; the out_re
    // rows take Fy_re, then -Fy_im; the out_im rows Fy_im, Fy_re
    const uint4 fr = F[s & 1][0], fi = F[s & 1][1];
    const uint4 A0 = s < 2 ? fr : neg_bf16x8(fi);
    const uint4 A1 = s < 2 ? fi : fr;
    const unsigned tb = yb + (((s & 1) * 16) * kBTS + (s >> 1) * kBKC) * 2;
#pragma unroll
    for (int p = 0; p < kBKC / 16; ++p) {
      unsigned b[4];
      ldsm_x4_trans(tb + p * 16 * 2, b);
      mma_bf16(acc[0][2 * p], A0.x, A0.y, A0.z, A0.w, b[0], b[1]);
      mma_bf16(acc[0][2 * p + 1], A0.x, A0.y, A0.z, A0.w, b[2], b[3]);
      mma_bf16(acc[1][2 * p], A1.x, A1.y, A1.z, A1.w, b[0], b[1]);
      mma_bf16(acc[1][2 * p + 1], A1.x, A1.y, A1.z, A1.w, b[2], b[3]);
    }
  }
}

// The y-stage's (2 Ry, kBKC) sums of row tile yr into out (slab, Ry, Kzc)
// complex, columns of chunk `chunk`; out is interleaved complex, so the
// part selects the float of the pair. Rows past Ry, columns past Kzc are
// not stored.
__device__ __forceinline__ void y_stage_store(const float (&acc)[2][kBKC / 8][4],
                                              float* __restrict__ out,
                                              size_t slab, int yr, int chunk,
                                              const BfDims& d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = yr * 16 + g + 8 * h;
      if (r >= d.ry) continue;
      float* o = out + ((slab * d.ry + r) * d.kzc) * 2 + part;
#pragma unroll
      for (int n = 0; n < kBKC / 8; ++n) {
        const int col = chunk * kBKC + n * 8 + 2 * tq;
        if (col < d.kzc) o[col * 2] = acc[part][n][2 * h];
        if (col + 1 < d.kzc) o[(col + 1) * 2] = acc[part][n][2 * h + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kBThreads, 1)
zy_forward_bf16_kernel(const float* __restrict__ w,
                       const uint4* __restrict__ fzb,
                       const uint4* __restrict__ afrag,
                       float* __restrict__ out, BfDims d, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nzs = d.nzp + 8;  // row stride of the w and Fz tiles
  float* wbuf0 = reinterpret_cast<float*>(smem);           // [kBTY][nzs]
  float* wbuf1 = wbuf0 + kBTY * nzs;                       // [kBTY][nzs]
  unsigned short* fz_s =
      reinterpret_cast<unsigned short*>(wbuf1 + kBTY * nzs);  // [kBN1][nzs]
  unsigned short* t_s = fz_s + kBN1 * nzs;                    // [kBTY][kBTS]
  const int chunk = blockIdx.x % d.nchunks, rpart = blockIdx.x / d.nchunks;
  const size_t slab = blockIdx.y;
  const float* wx = w + slab * d.ny * d.nz;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // mma fragment coordinates
  const int q = lane >> 3, r8 = lane & 7;   // ldmatrix matrix and row

  {  // the chunk's Fz rows, in the first cp.async group with w's tile 0
    const int cpr = d.nzp >> 3;
    const uint4* src = fzb + static_cast<size_t>(chunk) * kBN1 * cpr;
    for (int i = threadIdx.x; i < kBN1 * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(smem_u32(fz_s + r * nzs + c * 8), src + i, 16);
    }
  }
  load_w_tile(wx, wbuf0, 0, d, vec16);
  cp_async_commit();

  // z-stage work of this warp: m-tile zm of the tile's two, n-tiles
  // zn .. zn+1 of its 12; its B rows by ldmatrix (matrix q: n-tile q >> 1,
  // k half q & 1)
  const int zm = warp & 1, zn = (warp >> 1) * 16;
  const unsigned zb = smem_u32(fz_s + (zn + (q >> 1) * 8 + r8) * nzs +
                               (q & 1) * 8);
  // y-stage work: row tile yr of Ry (its out_re and out_im m-tiles); B by
  // ldmatrix.trans (matrix q: k half q & 1, n-tile q >> 1 of a pair)
  const int yr = rpart * kBWarps + warp;
  const bool act = yr < d.rt;
  const unsigned yb = smem_u32(t_s + ((q & 1) * 8 + r8) * kBTS + (q >> 1) * 8);
  float acc[2][kBKC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int j = 0; j < d.nyt; ++j) {
    // this tile's Fy fragments F[h][q], in flight over the wait and the
    // z-stage
    uint4 F[2][2];
    if (act) y_stage_frags(F, afrag, j, yr, d);
    const float* wb = (j & 1) ? wbuf1 : wbuf0;
    if (j + 1 < d.nyt) {
      // the other buffer was last read by tile j-1's z-stage, which every
      // thread finished before the barrier that follows it
      load_w_tile(wx, (j & 1) ? wbuf0 : wbuf1, (j + 1) * kBTY, d, vec16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j landed; tile j-1's y-stage is done with t_s

    {  // z-stage: t[y][n] = sum_z bf16(w[y][z]) bf16(Fz[n][z]), n of 96
      float zc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) zc[n][e] = 0.f;
      const float* w0 = wb + (zm * 16 + g) * nzs + 2 * tq;
      const float* w1 = w0 + 8 * nzs;
      for (int k0 = 0; k0 < d.nzp; k0 += 16) {
        const float2 x0 = *reinterpret_cast<const float2*>(w0 + k0);
        const float2 x1 = *reinterpret_cast<const float2*>(w1 + k0);
        const float2 x2 = *reinterpret_cast<const float2*>(w0 + k0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(w1 + k0 + 8);
        const unsigned a0 = pack_bf16(x0.x, x0.y), a1 = pack_bf16(x1.x, x1.y);
        const unsigned a2 = pack_bf16(x2.x, x2.y), a3 = pack_bf16(x3.x, x3.y);
        unsigned b[4];
        ldsm_x4(zb + k0 * 2, b);
        mma_bf16(zc[0], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(zc[1], a0, a1, a2, a3, b[2], b[3]);
      }
      // t rounded to bf16 once
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        unsigned short* t0 = t_s + (zm * 16 + g) * kBTS + zn + n * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(t0) = pack_bf16(zc[n][0], zc[n][1]);
        *reinterpret_cast<unsigned*>(t0 + 8 * kBTS) =
            pack_bf16(zc[n][2], zc[n][3]);
      }
    }
    __syncthreads();  // the tile's t is complete

    if (act) y_stage_mma(acc, F, yb);  // acc += A(j) [t_re; t_im]
  }
  if (act) y_stage_store(acc, out, slab, yr, chunk, d);
}

// ---------------------------------------------------------------------------
// K7 and K8 at 'default' on the tensor cores (mma.sync m16n8k16 bf16).
//
// The TPU DEFAULT's rounding points, which are also the twins' at
// 'default': the spectrum a and Fyi_t rounded to bf16 (RNE); the y-inverse
// with fp32 sums (two real products per part, summed after, as in the JAX
// kernel); t rounded to bf16 once;
// the z-unfold [t_re | t_im] [Bz_re; -Bz_im] with Bz in bf16 and an fp32
// sum. K8 then takes u x omega in fp32, rounds the products to bf16 for the
// z-forward (Fz in bf16, fp32 sum), rounds its t1 to bf16 once, and runs
// K6's y-stage on it (Fy in bf16, fp32 sum, fp32 output).
//
// A block owns one slab x and one y-tile of kVTY rows, walked by kVWarps
// warps. It converts the slab's whole (Ry, Kzc) spectrum to bf16 in shared
// memory (a_s: row b holds the re parts, then the im parts, of its Kzc
// columns, zero-padded to kp, a multiple of 16), so that every row tile of
// the y-inverse reads it by ldmatrix.trans; the y-inverse's A fragments
// (Fyi) come from global memory in fragment order, one 16-byte load per
// lane, table `afi`. t lands in shared memory as bf16 (t_s, the same
// re | im column layout), and the z-unfold reads it by ldmatrix as its A
// operand; its B fragments (Bz) come from global memory in fragment order,
// table `bzf`, and each warp takes one 16-column z pair for both row tiles
// of the y-tile, so the block reads the Bz table once. Every shape is
// zero-padded in shared memory and in the tables (Ry and Kzc to 16, nz to
// 16, y to kVTY), and the ragged edges are masked at the stores.
// ---------------------------------------------------------------------------
constexpr int kVTY = 32;  // y-rows per tile
constexpr int kVWarps = 12;
constexpr int kVThreads = 32 * kVWarps;

struct VDims {
  int nx, ny, nz, ry, kzc;
  int kp;   // kzc rounded up to 16
  int ryp;  // ry rounded up to 16
  int nzp;  // nz rounded up to 16
  int nyp;  // ny rounded up to kVTY
  int ks;   // row stride (bf16 values) of a_s, t_s and K8's S tile: 2 kp + 8
  int ls;   // row stride of K8's product tile: nzp + 8
};

// One slab's spectrum src (ry, kzc) complex into a_s [ryp][ks] as bf16:
// re at columns [0, kp), im at [kp, 2 kp), zero past ry and kzc. Each
// thread issues U items' loads (four complex each) before it converts
// them, so that their L2 latency overlaps.
template <int U>
__device__ __forceinline__ void load_spec_slab(const float2* __restrict__ src,
                                               unsigned short* a_s,
                                               const VDims& d) {
  const int qpr = d.kp >> 2;  // four-column quads per row
  const int n = d.ryp * qpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * blockDim.x) {
    float2 v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      const int b = i / qpr, k0 = (i - b * qpr) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = i < n && b < d.ry && k0 + j < d.kzc;
        v[u][j] = ok ? __ldg(src + static_cast<size_t>(b) * d.kzc + k0 + j)
                     : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int b = i / qpr, k0 = (i - b * qpr) * 4;
        unsigned short* row = a_s + b * d.ks + k0;
        *reinterpret_cast<uint2*>(row) =
            make_uint2(pack_bf16(v[u][0].x, v[u][1].x),
                       pack_bf16(v[u][2].x, v[u][3].x));
        *reinterpret_cast<uint2*>(row + d.kp) =
            make_uint2(pack_bf16(v[u][0].y, v[u][1].y),
                       pack_bf16(v[u][2].y, v[u][3].y));
      }
    }
  }
}

// y-inverse of one field for y-tile `ytile`: t_s [kVTY][ks] (re | im
// columns) = bf16(Fyi rows of the tile @ a_s). As in the JAX kernel
// (_inv_kernel), each part is two real products summed after: t_re =
// Fyi_re a_re - Fyi_im a_im, t_im = Fyi_re a_im + Fyi_im a_re, four fp32
// accumulators, so that t rounds to bf16 where the TPU's and the twin's t
// round. afi: Fyi_t in mma A fragment order, (ryp/16, nyp/16, 2, 32)
// uint4: entry (s, m, q, lane) holds lane's fragment of the 16x16 tile of
// Fyi_re (q = 0) or Fyi_im (q = 1) at rows y = 16 m .., columns b = 16 s ...
// A work item is one 16-row tile and one pair of 8-column n-tiles. The
// fragments arrive G k-steps at a time, the next G in flight while these
// are used, so that one L2 latency is paid per G steps, not per step.
template <int G>
__device__ __forceinline__ void y_inverse_bf16(const uint4* __restrict__ afi,
                                               const unsigned short* a_s,
                                               unsigned short* t_s, int ytile,
                                               const VDims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int nsteps = d.ryp >> 4;
  const size_t sstride = static_cast<size_t>(d.nyp >> 4) * 2 * 32;
  for (int item = warp; item < 2 * (d.kp >> 4); item += kVWarps) {
    const int mt = item & 1, np = item >> 1;
    // Fyi_re a_re, Fyi_im a_im, Fyi_re a_im, Fyi_im a_re
    float acc[4][2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
    const uint4* af = afi + (static_cast<size_t>(2 * ytile + mt) * 2) * 32 + lane;
    const unsigned base =
        smem_u32(a_s + ((q & 1) * 8 + r8) * d.ks + np * 16 + (q >> 1) * 8);
    uint4 cur[G][2], nxt[G][2];  // (Fyi_re, Fyi_im) of G k-steps
    auto fetch = [&](int s0, uint4(&f)[G][2]) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (s0 + j < nsteps) {
          f[j][0] = __ldg(af + (s0 + j) * sstride);
          f[j][1] = __ldg(af + (s0 + j) * sstride + 32);
        }
    };
    fetch(0, cur);
    for (int s0 = 0; s0 < nsteps; s0 += G) {
      const bool more = s0 + G < nsteps;
      if (more) fetch(s0 + G, nxt);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int s = s0 + j;
        if (s >= nsteps) break;
        const uint4 fr = cur[j][0], fi = cur[j][1];
        unsigned br[4], bi[4];
        ldsm_x4_trans(base + s * 16 * d.ks * 2, br);
        ldsm_x4_trans(base + (s * 16 * d.ks + d.kp) * 2, bi);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_bf16(acc[0][n], fr.x, fr.y, fr.z, fr.w, br[2 * n], br[2 * n + 1]);
          mma_bf16(acc[1][n], fi.x, fi.y, fi.z, fi.w, bi[2 * n], bi[2 * n + 1]);
          mma_bf16(acc[2][n], fr.x, fr.y, fr.z, fr.w, bi[2 * n], bi[2 * n + 1]);
          mma_bf16(acc[3][n], fi.x, fi.y, fi.z, fi.w, br[2 * n], br[2 * n + 1]);
        }
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          cur[j][0] = nxt[j][0];
          cur[j][1] = nxt[j][1];
        }
      }
    }
    // t rounded to bf16 once
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          t[e] = p ? acc[2][n][e] + acc[3][n][e] : acc[0][n][e] - acc[1][n][e];
        unsigned short* t0 =
            t_s + (mt * 16 + g) * d.ks + p * d.kp + np * 16 + n * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(t0) = pack_bf16(t[0], t[1]);
        *reinterpret_cast<unsigned*>(t0 + 8 * d.ks) = pack_bf16(t[2], t[3]);
      }
  }
}

// z-unfold of NF fields for z pair zp (z = 16 zp .. 16 zp + 15) and both
// row tiles of the y-tile: acc[f][m][n] += [t_re | t_im] of field f (t_s +
// f kVTY ks) @ [Bz_re; -Bz_im]. bzf: B fragments, (nzp/16, 2 kp/16, 32)
// uint4: entry (zp, ks, lane) holds the A-fragment order of the 16x16 tile
// of [Bz_re; -Bz_im]^T at rows z = 16 zp .., columns 16 ks .., whose
// registers (x, z) are n-tile 0's B fragment and (y, w) n-tile 1's. The
// fragments arrive G k-steps at a time, as in y_inverse_bf16.
template <int NF, int G>
__device__ __forceinline__ void z_unfold_bf16(float (&acc)[NF][2][2][4],
                                              const uint4* __restrict__ bzf,
                                              const unsigned short* t_s,
                                              int zp, const VDims& d) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  const int nks = d.kp >> 3;  // 2 kp / 16
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][m][n][e] = 0.f;
  const uint4* bf = bzf + static_cast<size_t>(zp) * nks * 32 + lane;
  const unsigned abase =
      smem_u32(t_s + ((q & 1) * 8 + r8) * d.ks + (q >> 1) * 8);
  uint4 cur[G], nxt[G];
  auto fetch = [&](int k0, uint4(&v)[G]) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (k0 + j < nks) v[j] = __ldg(bf + (k0 + j) * 32);
  };
  fetch(0, cur);
  for (int k0 = 0; k0 < nks; k0 += G) {
    const bool more = k0 + G < nks;
    if (more) fetch(k0 + G, nxt);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int k = k0 + j;
      if (k >= nks) break;
      const uint4 v = cur[j];
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          unsigned a[4];
          ldsm_x4(abase + ((f * kVTY + m * 16) * d.ks + k * 16) * 2, a);
          mma_bf16(acc[f][m][0], a[0], a[1], a[2], a[3], v.x, v.z);
          mma_bf16(acc[f][m][1], a[0], a[1], a[2], a[3], v.y, v.w);
        }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < G; ++j) cur[j] = nxt[j];
    }
  }
}

// K7 at 'default': grid (B*nx, nyp/kVTY) of kVThreads.
__global__ void __launch_bounds__(kVThreads, 2)
yz_inverse_bf16_kernel(const float2* __restrict__ a,
                       const uint4* __restrict__ afi,
                       const uint4* __restrict__ bzf, float* __restrict__ out,
                       VDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* a_s = reinterpret_cast<unsigned short*>(smem);  // [ryp][ks]
  unsigned short* t_s = a_s + d.ryp * d.ks;                        // [kVTY][ks]
  const size_t slab = blockIdx.x;
  const int ytile = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  load_spec_slab<2>(a + slab * d.ry * d.kzc, a_s, d);
  __syncthreads();
  y_inverse_bf16<2>(afi, a_s, t_s, ytile, d);
  __syncthreads();
  for (int zp = warp; zp < (d.nzp >> 4); zp += kVWarps) {
    float acc[1][2][2][4];
    z_unfold_bf16<1, 2>(acc, bzf, t_s, zp, d);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = ytile * kVTY + m * 16 + g + 8 * h;
        if (y >= d.ny) continue;
        float* o = out + (slab * d.ny + y) * d.nz;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int z = zp * 16 + n * 8 + 2 * tq;
          if (z < d.nz) o[z] = acc[0][m][n][2 * h];
          if (z + 1 < d.nz) o[z + 1] = acc[0][m][n][2 * h + 1];
        }
      }
  }
}

// K8 at 'default', first launch: grid (nx, nyp/kVTY) of kVThreads. For
// each of the six fields in turn, the slab's spectrum into a_s and the
// y-inverse of the tile into t_s[f]; then the z-unfold of all six fields
// into accumulators of one fragment layout, so u x omega is taken lane by
// lane in fp32; the three products rounded to bf16 into l_s (over a_s,
// which is no longer read); the z-forward t1 = products @ [Fz_re; Fz_im]^T;
// t1 rounded to bf16 once into the tile's rows of s (3, nx, nyp, 2 kp),
// staged through shared memory (over t_s) so the stores are whole 16-byte
// rows. fzf: the z-forward's B fragments, (2 kp/16, nzp/16, 32) uint4:
// entry (p, zs, lane) is the A-fragment order of the 16x16 tile of
// [Re Fz_t; Im Fz_t] (rows 2 kp, zero-padded) at rows 16 p .., columns
// z = 16 zs ...
__global__ void __launch_bounds__(kVThreads, 1)
lamb_phys_bf16_kernel(const float2* __restrict__ a6,
                      const uint4* __restrict__ afi,
                      const uint4* __restrict__ bzf,
                      const uint4* __restrict__ fzf,
                      unsigned short* __restrict__ s, VDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* u_s = reinterpret_cast<unsigned short*>(smem);
  // a_s [ryp][ks], then l_s [3][kVTY][ls]
  const int u_size = max(d.ryp * d.ks, 3 * kVTY * d.ls);
  unsigned short* t_s = u_s + u_size;  // [6][kVTY][ks], then [3][kVTY][ks]
  const int x = blockIdx.x, ytile = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, q = lane >> 3, r8 = lane & 7;
  const size_t spec = static_cast<size_t>(d.ry) * d.kzc;
  const int tsz = kVTY * d.ks;
  for (int f = 0; f < 6; ++f) {
    if (f) __syncthreads();  // field f-1's y-inverse is done with a_s
    load_spec_slab<8>(a6 + (static_cast<size_t>(f) * d.nx + x) * spec, u_s, d);
    __syncthreads();
    y_inverse_bf16<4>(afi, u_s, t_s + f * tsz, ytile, d);
  }
  __syncthreads();

  // z-unfold of the six fields and the cross product, per z pair
  for (int zp = warp; zp < (d.nzp >> 4); zp += kVWarps) {
    float acc[6][2][2][4];
    z_unfold_bf16<6, 4>(acc, bzf, t_s, zp, d);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float l[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u1 = acc[0][m][n][e], u2 = acc[1][m][n][e],
                      u3 = acc[2][m][n][e];
          const float w1 = acc[3][m][n][e], w2 = acc[4][m][n][e],
                      w3 = acc[5][m][n][e];
          l[0][e] = u2 * w3 - u3 * w2;
          l[1][e] = u3 * w1 - u1 * w3;
          l[2][e] = u1 * w2 - u2 * w1;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          unsigned short* l0 = u_s + (c * kVTY + m * 16 + g) * d.ls + zp * 16 +
                               n * 8 + 2 * tq;
          *reinterpret_cast<unsigned*>(l0) = pack_bf16(l[c][0], l[c][1]);
          *reinterpret_cast<unsigned*>(l0 + 8 * d.ls) =
              pack_bf16(l[c][2], l[c][3]);
        }
      }
  }
  __syncthreads();

  // z-forward of the three products, per pair of 8-column tiles of t1's
  // 2 kp columns (re | im); t1 rounded to bf16 into t_s [3][kVTY][ks]
  const int nzs = d.nzp >> 4;
  const unsigned lbase =
      smem_u32(u_s + ((q & 1) * 8 + r8) * d.ls + (q >> 1) * 8);
  for (int p = warp; p < (d.kp >> 3); p += kVWarps) {
    float acc[3][2][2][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][m][n][e] = 0.f;
    const uint4* ff = fzf + static_cast<size_t>(p) * nzs * 32 + lane;
    constexpr int G = 4;  // z-steps of fragments in flight, as in the z-unfold
    uint4 cur[G], nxt[G];
    auto fetch = [&](int k0, uint4(&v)[G]) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (k0 + j < nzs) v[j] = __ldg(ff + (k0 + j) * 32);
    };
    fetch(0, cur);
    for (int k0 = 0; k0 < nzs; k0 += G) {
      const bool more = k0 + G < nzs;
      if (more) fetch(k0 + G, nxt);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int k = k0 + j;
        if (k >= nzs) break;
        const uint4 v = cur[j];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            unsigned a[4];
            ldsm_x4(lbase + ((c * kVTY + m * 16) * d.ls + k * 16) * 2, a);
            mma_bf16(acc[c][m][0], a[0], a[1], a[2], a[3], v.x, v.z);
            mma_bf16(acc[c][m][1], a[0], a[1], a[2], a[3], v.y, v.w);
          }
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < G; ++j) cur[j] = nxt[j];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          unsigned short* t0 = t_s + (c * kVTY + m * 16 + g) * d.ks + p * 16 +
                               n * 8 + 2 * tq;
          *reinterpret_cast<unsigned*>(t0) =
              pack_bf16(acc[c][m][n][0], acc[c][m][n][1]);
          *reinterpret_cast<unsigned*>(t0 + 8 * d.ks) =
              pack_bf16(acc[c][m][n][2], acc[c][m][n][3]);
        }
  }
  __syncthreads();

  // the tile's t1 rows to s, 16 bytes a thread
  const int ppr = d.kp >> 2;  // 16-byte pieces per row of 2 kp bf16
  for (int i = threadIdx.x; i < 3 * kVTY * ppr; i += blockDim.x) {
    const int row = i / ppr, piece = i - row * ppr;  // row = c kVTY + r
    const int c = row / kVTY, r = row - c * kVTY;
    const size_t srow =
        (static_cast<size_t>(c) * d.nx + x) * d.nyp + ytile * kVTY + r;
    *reinterpret_cast<uint4*>(s + srow * 2 * d.kp + piece * 8) =
        *reinterpret_cast<const uint4*>(t_s + row * d.ks + piece * 8);
  }
}

// K8 at 'default', second launch: K6's y-stage on s. Grid (nchunks *
// rparts, 3*nx) of kBThreads, one block per (Kzc chunk, part of the Ry
// rows, component and slab). Each y-tile's t1 columns of the chunk (re:
// kBKC columns from chunk * kBKC, im: the same from kp on; zero past kp)
// arrive by cp.async into one of two buffers while the other is used.
__global__ void __launch_bounds__(kBThreads, 1)
lamb_yfwd_bf16_kernel(const unsigned short* __restrict__ s,
                      const uint4* __restrict__ afrag,
                      float* __restrict__ out, BfDims d, int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* t_s = reinterpret_cast<unsigned short*>(smem);  // [2][kBTY][kBTS]
  const int chunk = blockIdx.x % d.nchunks, rpart = blockIdx.x / d.nchunks;
  const size_t slab = blockIdx.y;  // c * nx + x
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, r8 = lane & 7;
  const unsigned short* sx = s + slab * d.nyt * kBTY * 2 * kp;
  // thread i copies 16 bytes: row i / 12 of the tile, piece i % 12 (six of
  // the re columns, then six of the im columns)
  const int crow = threadIdx.x / 12, cp = threadIdx.x - crow * 12;
  const int ccol = chunk * kBKC + (cp % 6) * 8;
  const bool cok = ccol < kp;
  const int csrc = crow * 2 * kp + (cp / 6) * kp + ccol;
  const int cdst = crow * kBTS + (cp / 6) * kBKC + (cp % 6) * 8;
  auto load = [&](int j, int buf) {
    cp_async16(smem_u32(t_s + buf * kBTY * kBTS + cdst),
               cok ? sx + static_cast<size_t>(j) * kBTY * 2 * kp + csrc : sx,
               cok ? 16 : 0);
    cp_async_commit();
  };
  const int yr = rpart * kBWarps + warp;
  const bool act = yr < d.rt;
  float acc[2][kBKC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  load(0, 0);
  for (int j = 0; j < d.nyt; ++j) {
    uint4 F[2][2];
    if (act) y_stage_frags(F, afrag, j, yr, d);
    __syncthreads();  // tile j-1's y-stage is done with the other buffer
    if (j + 1 < d.nyt) {
      load(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j landed
    const unsigned yb = smem_u32(t_s + (j & 1) * kBTY * kBTS +
                                 ((q & 1) * 8 + r8) * kBTS + (q >> 1) * 8);
    if (act) y_stage_mma(acc, F, yb);
  }
  if (act) y_stage_store(acc, out, slab, yr, chunk, d);
}

// ---------------------------------------------------------------------------
// K6, K7 and K8 at 'high' and 'highest' on the tensor cores: 3xTF32.
//
// Each product a b of fp32 operands runs on the TF32 tensor cores (mma.sync
// m16n8k8 tf32, fp32 accumulator) as three: with x = big + small, big =
// tf32(x) and small = tf32(x - big) (cvt.rna: to nearest, ties away from
// zero, at 10 mantissa bits; x - big is exact in fp32), acc += a_small
// b_big, then a_big b_small, then a_big b_big. The dropped a_small b_small
// and small's own rounding are ~2^-22 of the product, so the sums stay
// fp32-class, as the HIGHEST contract wants (one TF32 product, ~3e-4 of
// max|out|, does not keep it). The DFT tables are split once by the
// wrappers (ops/kernels/transform3d_kernels.py: tf32_tables,
// inverse_tf32_tables) into big and small planes in mma fragment order;
// the data (K6: w, K7 and K8: the spectrum) are split in registers after
// each load from shared memory; K6's and K7's intermediate t is split
// once, as it is stored to shared memory, into big and small planes that
// the second GEMM reads as they are (K8's intermediates: its own note).
//
// Fragment order: the contraction index k of each 8-deep MMA step is
// permuted so that a lane's two k values are neighbours: k = tq comes from
// position 2 tq of the step and k = tq + 4 from 2 tq + 1 (g = lane / 4, tq
// = lane % 4). So a lane's A values (rows g and g + 8) and B values
// (column g) of a step are float2 loads from a row-major tile, free of bank
// conflicts at a row stride of 8 mod 16 floats (2 mod 16 float2). A table
// entry (step s, tile r, lane) holds A registers (a0, a1, a2, a3) = X[16 r
// + g + 8 (i % 2)][8 s + 2 tq + i / 2], i = 0..3, big and small in planes
// of their own, or B registers (b0 big, b1 big, b0 small, b1 small) with
// b_i = X[8 s + 2 tq + i][8 n + g].
//
// Bounds (three TF32 products a multiply-add at 495 TFLOP/s, or bytes at
// 3.35 TB/s, whichever is larger; the fp32 FMA figure beside it): K6 at
// 256^3, B=3, 0.245 ms (fp32: 0.60 ms); K7, B=1, 0.082 ms (fp32: 0.20 ms).
// Both are bound by their products. The designs keep the tensor cores fed:
// every MMA operand comes from registers, from shared memory in float2 or
// 16-byte loads free of bank conflicts, or from a fragment-order table
// (L2-resident) loaded one step ahead; the outputs accumulate in registers
// and are written once; only w and the spectrum are read from device
// memory. Each step's products go through a fresh MMA accumulator and are
// added to the fp32 sums in registers (mma3, mma6): the tensor cores
// truncate as they accumulate, and chains of 66-384 MMAs into one sum read
// ~10x the fp32 twin's error against float64 on the H100.
//
// K6: grid (nchunks * rparts, B*nx) of kTThreads, one block per (Kzc chunk
// of kBKC columns, part of the Ry rows, slab), as K6's bf16 kernel. It
// walks the slab in y-tiles of kTTY rows. A tile's z-stage is the GEMM t
// (kTTY, 2 kBKC) = w (kTTY, nz) Fz_chunk^T over z-slices of kTKZ: a
// slice's w rows (fp32, cp.async, zero past ny and nz) and its Fz
// fragments (cp.async from the table) land in one of kTStages stage
// buffers, the next kTStages - 1 slices in flight while one is used (a
// slice is ~0.4 us of products, less than a copy's latency from device
// memory), one barrier a slice. Warp (zm, zg) computes m-tile zm and n-tiles
// 4 zg .. 4 zg + 3 of t. After the tile's last slice t is split and stored
// transposed (planes [big, small][n][y]), and the y-stage adds the tile's
// share of out = [[Fy_re, -Fy_im], [Fy_im, Fy_re]] [t_re; t_im]: warp w
// owns row tile yr of Ry (its out_re and out_im m-tiles, 48 fp32 a thread
// for the whole slab); Fy's fragments come from the table one step ahead
// (the first over the tile's last z-slice). Shared memory: 194,560 bytes
// at any grid.
//
// K7: grid (B*nx, nyp/kUTY) of kUThreads, one block per (slab, y-tile of
// kUTY rows). The slab's spectrum lands once in shared memory as fp32
// (cp.async, interleaved complex, zero past Ry and Kzc), while the first
// Fyi fragments are in flight. The y-inverse: warp w owns m-tile w (16
// y-rows) and every Kzc n-tile, t_re and t_im in registers; Fyi's
// fragments come from the table one step ahead, the spectrum's B values
// as float2 (re, im) loads split in registers. Then t is split into big
// and small planes over the spectrum (after a barrier), and the z-unfold
// [t_re | t_im] [Bz_re; -Bz_im] runs on items of (4 m-tiles, 4 z n-tiles),
// Bz's fragments one step ahead; the physical rows are written once.
//
// K8: two launches, on K7's tables (inverse_tf32_tables: Fyi, Bz) and K6's
// (tf32_tables: Fz by Kzc chunk, Fy); bound at 256^3 by its 3xTF32
// products, 0.735 ms. The TPU kernel holds an x-slab's six fields, their
// physical rows and the products in VMEM; here one slab's spectrum in fp32
// (138 KB at 256^3) and the six fields' y-inverse of a y-tile do not both
// fit a block's 227 KB. So the first launch, one block per (y-tile of kLTY
// = 16 rows, slab x), never holds the spectrum: it streams it through a
// ring of kLStages k-steps (8 Ry rows of all six fields, with the step's
// Fyi fragments; cp.async, zero past Ry and Kzc) while the y-inverse of
// the six fields accumulates in registers: warp (f, h) owns field f and
// half h of the Kzc n-tiles, t_re and t_im (K7's arithmetic). Over the
// dead ring, t is stored unsplit ([6][16][st]: the z-unfold splits its A
// fragments as it loads them) and the products' planes after it. The
// z-unfold [t_re | t_im] [Bz_re; -Bz_im] gives each warp up to kLZW z
// n-tiles of all six fields, so u x omega is taken lane by lane in fp32
// and split into big and small planes ([3][2][16][ls]). The z-forward t1 =
// products @ Fz_chunk^T takes items of (component, Kzc chunk, re or im
// half: six n-tiles), Fz's fragments from K6's table one step ahead, and
// writes t1, split, into S: (3 nx, nchunks, 2 planes, kTN1, nyp) floats,
// y contiguous, which is the transposed t tile of K6's y-stage. The
// second launch is K6's y-stage on S (grid and warps as K6's), its tiles
// arriving by cp.async, two in flight. Shared memory: the larger of the
// ring and t with the product planes, 172,032 bytes at 256^3, and 110,592
// for the second launch; less than K7's 3xTF32 kernel wherever that fits
// (smem_bytes). Rows past ny are zero in Fyi's table, so S is zero there
// and the second launch reads it as it reads real rows.
// ---------------------------------------------------------------------------
constexpr int kTTY = 64;                            // K6 y-rows per tile
constexpr int kTKZ = 32;                            // K6 z per slice
constexpr int kTWS = kTKZ + 8;                      // w slice row stride
constexpr int kTN1 = 2 * kBKC;                      // z-stage columns
constexpr int kTTS = kTTY + 8;                      // t plane row stride
constexpr int kTFz = (kTKZ / 8) * (kTN1 / 8) * 32;  // uint4 of a Fz slice
constexpr int kTStages = 4;                         // z-slices in flight
constexpr int kTWarps = 12;
constexpr int kTThreads = 32 * kTWarps;
constexpr int kUTY = 128;  // K7 y-rows per block
constexpr int kUWarps = kUTY / 16;
constexpr int kUThreads = 32 * kUWarps;
// K7's instances by Kzc n-tiles (a Kzc of 8 NT or less takes the first NT
// that holds it, the n-tiles past Kzc zero): the n-loops are unrolled
// without a branch. Its t planes (2 kUTY (16 NT + 8) floats) fit a block's
// shared memory up to NT = 13.
constexpr int kUNTs[] = {3, 6, 11, 13};
constexpr int kLTY = 16;        // K8 y-rows per block of its first launch
constexpr int kLWarps = 12;
constexpr int kLThreads = 32 * kLWarps;
constexpr int kLStages = 4;     // y-inverse k-steps in flight
constexpr int kLZW = 3;         // z n-tiles per warp and round of the z-unfold
constexpr int kLFyi = 4 * 32;   // uint4 of one k-step's Fyi fragments

struct TfDims {
  int ny, nz, ry, kzc;
  int nsl;      // z-slices, ceil(nz / kTKZ)
  int rt;       // 16-row tiles of Ry
  int nchunks;  // ceil(kzc / kBKC)
  int rparts;   // ceil(rt / kTWarps)
  int nyt;      // ceil(ny / kTTY)
};

struct TiDims {
  int ny, nz, ry, kzc;
  int ntk;  // Kzc n-tiles of the instance (NT), at least ceil(kzc / 8)
  int nks;  // y-inverse k-steps, ceil(ry / 8)
  int nzt;  // z n-tiles, nz rounded up to 32, over 8
  int sa;   // spectrum row stride (float2): 8 ntk rounded up to 16, + 2
  int st;   // t plane row stride (floats): 16 ntk + 8
};

// K8's first launch: K7's dims for its instance, and
struct LmDims {
  TiDims t;
  int nx;
  int ls;       // product plane row stride (floats): 8 nzt + 8
  int nchunks;  // Kzc chunks of kBKC columns (K6's Fz table)
  int nyp;      // S's y extent: ny rounded up to kTTY
};

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// x = big + small as tf32 (low 13 bits zero): big = rna(x), small =
// rna(x - big)
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  unsigned b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(x - __uint_as_float(b)));
  big = b;
  small = s & 0xffffe000u;
}

// A of one step from the lane's float2 loads of rows g (x0) and g + 8 (x1)
// (k = tq, k = tq + 4), split
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint4& big,
                                        uint4& small) {
  split_tf32(x0.x, big.x, small.x);
  split_tf32(x1.x, big.y, small.y);
  split_tf32(x0.y, big.z, small.z);
  split_tf32(x1.y, big.w, small.w);
}

// c += A B for one m16n8k8 tile: tf32 inputs, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// d = A B for one m16n8k8 tile into a fresh accumulator
__device__ __forceinline__ void mma_tf32_0(float (&d)[4], const uint4& a,
                                           unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// The split B values of one step: (b0, b1) big and small
struct SplitB {
  unsigned b0, b1, s0, s1;
};

__device__ __forceinline__ SplitB split_b(float b0, float b1) {
  SplitB b;
  split_tf32(b0, b.b0, b.s0);
  split_tf32(b1, b.b1, b.s1);
  return b;
}

// from the big and small planes' float2 loads
__device__ __forceinline__ SplitB planes_b(float2 big, float2 small) {
  return {__float_as_uint(big.x), __float_as_uint(big.y),
          __float_as_uint(small.x), __float_as_uint(small.y)};
}

// -B
__device__ __forceinline__ SplitB neg_b(const SplitB& b) {
  return {b.b0 ^ 0x80000000u, b.b1 ^ 0x80000000u, b.s0 ^ 0x80000000u,
          b.s1 ^ 0x80000000u};
}

// The tensor cores add the products of an MMA to its accumulator with
// truncation, so a chain of MMAs into one sum loses ~one ulp of the sum at
// every link. So each 8-deep step's products are taken into a fresh
// accumulator and added to the fp32 sum in registers with rounding to
// nearest.

// c += A B at 3xTF32 for one step, A = ab + as: the two cross terms, then
// the big product
__device__ __forceinline__ void mma3(float (&c)[4], const uint4& ab,
                                     const uint4& as, const SplitB& b) {
  float d[4];
  mma_tf32_0(d, as, b.b0, b.b1);
  mma_tf32(d, ab, b.s0, b.s1);
  mma_tf32(d, ab, b.b0, b.b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// c += A1 B1 + A2 B2 at 3xTF32 for one step: the four cross terms, then
// the two big products
__device__ __forceinline__ void mma6(float (&c)[4], const uint4& ab1,
                                     const uint4& as1, const SplitB& b1,
                                     const uint4& ab2, const uint4& as2,
                                     const SplitB& b2) {
  float d[4];
  mma_tf32_0(d, as1, b1.b0, b1.b1);
  mma_tf32(d, ab1, b1.s0, b1.s1);
  mma_tf32(d, as2, b2.b0, b2.b1);
  mma_tf32(d, ab2, b2.s0, b2.s1);
  mma_tf32(d, ab1, b1.b0, b1.b1);
  mma_tf32(d, ab2, b2.b0, b2.b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// acc += one y-step of K6's y-stage: out_re += Fy_re t_re + Fy_im (-t_im),
// out_im += Fy_im t_re + Fy_re t_im for the step's Fy fragments F (Fy_re
// big, small, Fy_im big, small) and the lane's position tb in a t tile of
// planes [big, small][kTN1][kTTS] (columns n < kBKC t_re, then t_im; y
// along the rows), at the step's first y.
__device__ __forceinline__ void y_step_tf32(float (&acc)[2][kBKC / 8][4],
                                            const uint4 (&F)[4],
                                            const float* tb) {
#pragma unroll
  for (int n = 0; n < kBKC / 8; ++n) {
    const float* p = tb + n * 8 * kTTS;
    const float2 rb = *reinterpret_cast<const float2*>(p);
    const float2 rs = *reinterpret_cast<const float2*>(p + kTN1 * kTTS);
    const float2 ib = *reinterpret_cast<const float2*>(p + kBKC * kTTS);
    const float2 is =
        *reinterpret_cast<const float2*>(p + (kTN1 + kBKC) * kTTS);
    const SplitB tr = planes_b(rb, rs), ti = planes_b(ib, is);
    mma6(acc[0][n], F[0], F[1], tr, F[2], F[3], neg_b(ti));
    mma6(acc[1][n], F[2], F[3], tr, F[0], F[1], ti);
  }
}

// fzt (nchunks, nsl * kTKZ / 8, kTN1 / 8, 32) uint4: chunk c's Fz rows (n <
// kBKC: Re Fz_t[c kBKC + n], then Im) as B fragments of their transpose (k
// = z, zero past nz and Kzc). fya (nyt * kTTY / 8 + 1, rt, 4, 32) uint4:
// Fy_t's A fragments, entry (s, r, q, lane) the (16 r .., 8 s ..) tile of
// Fy_re big (q = 0), Fy_re small, Fy_im big, Fy_im small, zero past Ry and
// ny (one step past the last tile, which the y-stage prefetches).
__global__ void __launch_bounds__(kTThreads, 1)
zy_forward_tf32_kernel(const float* __restrict__ w,
                       const uint4* __restrict__ fzt,
                       const uint4* __restrict__ fya,
                       float* __restrict__ out, TfDims d, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* fz_s = reinterpret_cast<uint4*>(smem);  // [kTStages][kTFz]
  float* w_s =
      reinterpret_cast<float*>(fz_s + kTStages * kTFz);  // [kTStages][kTTY][kTWS]
  float* t_s = w_s + kTStages * kTTY * kTWS;  // [2 (big, small)][kTN1][kTTS]
  const int chunk = blockIdx.x % d.nchunks, rpart = blockIdx.x / d.nchunks;
  const size_t slab = blockIdx.y;
  const float* wx = w + slab * d.ny * d.nz;
  const uint4* fzc = fzt + static_cast<size_t>(chunk) * d.nsl * kTFz;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // stage i = (y-tile i / nsl, z-slice i % nsl) into buffer i % kTStages
  auto load_stage = [&](int i) {
    const int j = i / d.nsl, sl = i - j * d.nsl, buf = i % kTStages;
    const uint4* src = fzc + static_cast<size_t>(sl) * kTFz;
    uint4* dst = fz_s + buf * kTFz;
    for (int q = threadIdx.x; q < kTFz; q += kTThreads)
      cp_async16(smem_u32(dst + q), src + q, 16);
    float* wb = w_s + buf * kTTY * kTWS;
    const int y0 = j * kTTY, z0 = sl * kTKZ;
    if (vec16) {  // nz % 4 == 0 and w 16-byte aligned: whole 16-byte chunks
      constexpr int cpr = kTKZ / 4;
      for (int q = threadIdx.x; q < kTTY * cpr; q += kTThreads) {
        const int r = q / cpr, c = (q - r * cpr) * 4;
        const int y = y0 + r, z = z0 + c;
        const bool ok = y < d.ny && z < d.nz;
        cp_async16(smem_u32(wb + r * kTWS + c),
                   ok ? wx + static_cast<size_t>(y) * d.nz + z : wx,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < kTTY * kTKZ; q += kTThreads) {
        const int r = q / kTKZ, c = q - r * kTKZ;
        const int y = y0 + r, z = z0 + c;
        const bool ok = y < d.ny && z < d.nz;
        cp_async4(smem_u32(wb + r * kTWS + c),
                  ok ? wx + static_cast<size_t>(y) * d.nz + z : wx,
                  ok ? 4 : 0);
      }
    }
  };

  const int zm = warp & 3, zn0 = (warp >> 2) * 4;  // z-stage tiles
  const int yr = rpart * kTWarps + warp;           // y-stage row tile
  const bool act = yr < d.rt;
  float acc[2][kBKC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  uint4 F[4], Fn[4];  // Fy fragments of this y-step and the next
  auto fetch = [&](int s8, uint4(&f)[4]) {
    const uint4* p =
        fya + (static_cast<size_t>(s8) * d.rt + yr) * 4 * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = __ldg(p + q * 32);
  };

  // kTStages - 1 stages in flight ahead of the one computed; one
  // cp.async group a stage (empty past the last), so that waiting for all
  // but the newest kTStages - 2 groups waits for stage i
  const int nst = d.nyt * d.nsl;
#pragma unroll
  for (int i = 0; i < kTStages - 1; ++i) {
    if (i < nst) load_stage(i);
    cp_async_commit();
  }
  for (int j = 0, i = 0; j < d.nyt; ++j) {
    // z-stage of y-tile j, stage i = (j, sl)
    float zc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) zc[n][e] = 0.f;
    for (int sl = 0; sl < d.nsl; ++sl, ++i) {
      cp_async_wait<kTStages - 2>();
      // stage i landed for every thread, and every thread is done with
      // stage i - 1, whose buffer the load below refills
      __syncthreads();
      if (i + kTStages - 1 < nst) load_stage(i + kTStages - 1);
      cp_async_commit();
      // the y-stage's first fragments, in flight over the last slice
      if (sl == d.nsl - 1 && act) fetch(j * (kTTY / 8), F);
      // t += w Fz^T over the slice, w split in registers
      const int buf = i % kTStages;
      const float* wr =
          w_s + buf * kTTY * kTWS + (zm * 16 + g) * kTWS + 2 * tq;
      const uint4* fb = fz_s + buf * kTFz + zn0 * 32 + lane;
#pragma unroll
      for (int ks = 0; ks < kTKZ / 8; ++ks) {
        uint4 ab, as;
        split_a(*reinterpret_cast<const float2*>(wr + ks * 8),
                *reinterpret_cast<const float2*>(wr + 8 * kTWS + ks * 8), ab,
                as);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint4 b = fb[(ks * (kTN1 / 8) + n) * 32];
          mma3(zc[n], ab, as, SplitB{b.x, b.y, b.z, b.w});
        }
      }
    }
    // the tile's t, split into the big and small planes, transposed: zc[n]
    // holds rows zm 16 + g (+ 8), columns (zn0 + n) 8 + 2 tq (+ 1); every
    // thread finished the previous tile's y-stage before this tile's
    // slice barriers
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (zn0 + n) * 8 + 2 * tq + (e & 1);
        const int row = zm * 16 + g + 8 * (e >> 1);
        unsigned b, s;
        split_tf32(zc[n][e], b, s);
        t_s[col * kTTS + row] = __uint_as_float(b);
        t_s[(kTN1 + col) * kTTS + row] = __uint_as_float(s);
      }
    __syncthreads();  // the tile's t is complete
    if (act) {  // the y-stage over the tile's y-steps
      const float* tb = t_s + g * kTTS + 2 * tq;
#pragma unroll 1
      for (int k = 0; k < kTTY / 8; ++k) {
        // the next step's (the table has one step past the last tile)
        fetch(j * (kTTY / 8) + k + 1, Fn);
        y_step_tf32(acc, F, tb + k * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) F[q] = Fn[q];
      }
    }
  }
  if (act) {
    BfDims bd;
    bd.ry = d.ry;
    bd.kzc = d.kzc;
    y_stage_store(acc, out, slab, yr, chunk, bd);
  }
}

// fia (nyp/16, nks, 4, 32) uint4: Fyi_t's A fragments, entry (m, s, q,
// lane) the (16 m .., 8 s ..) tile of Fyi_re big (q = 0), Fyi_re small,
// Fyi_im big, Fyi_im small, zero past ny and Ry (nyp: ny rounded up to
// kUTY). bzt (2 ntk, nzt, 32) uint4: [Bz_re; -Bz_im] (16 ntk rows, re rows
// from 0 and im rows from 8 ntk, zero past Kzc and nz) as B fragments.
template <int NT>
__global__ void __launch_bounds__(kUThreads, 1)
yz_inverse_tf32_kernel(const float2* __restrict__ a,
                       const uint4* __restrict__ fia,
                       const uint4* __restrict__ bzt, float* __restrict__ out,
                       TiDims d, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* a_s = reinterpret_cast<float2*>(smem);  // [8 nks][sa]
  float* t_s = reinterpret_cast<float*>(smem);  // [2][kUTY][st], after a_s
  const size_t slab = blockIdx.x;
  const int ytile = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  constexpr int cols = NT * 8;
  {  // the slab's spectrum, zero past Ry and Kzc
    const float2* src = a + slab * d.ry * d.kzc;
    const int rows = d.nks * 8;
    if (vec16) {  // Kzc even and a 16-byte aligned: two complex a copy
      const int ppr = cols / 2;
      for (int q = threadIdx.x; q < rows * ppr; q += kUThreads) {
        const int r = q / ppr, c = (q - r * ppr) * 2;
        const bool ok = r < d.ry && c < d.kzc;
        cp_async16(smem_u32(a_s + r * d.sa + c),
                   ok ? src + static_cast<size_t>(r) * d.kzc + c : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < rows * cols; q += kUThreads) {
        const int r = q / cols, c = q - r * cols;
        const bool ok = r < d.ry && c < d.kzc;
        cp_async8(smem_u32(a_s + r * d.sa + c),
                  ok ? src + static_cast<size_t>(r) * d.kzc + c : src,
                  ok ? 8 : 0);
      }
    }
    cp_async_commit();
  }
  const uint4* fp =
      fia + static_cast<size_t>(ytile * kUWarps + warp) * d.nks * 4 * 32 +
      lane;
  uint4 F[4], Fn[4];  // Fyi fragments of this k-step and the next
#pragma unroll
  for (int q = 0; q < 4; ++q) F[q] = __ldg(fp + q * 32);
  cp_async_wait<0>();
  __syncthreads();  // the spectrum landed

  // y-inverse: t_re += Fyi_re a_re + Fyi_im (-a_im), t_im += Fyi_re a_im
  // + Fyi_im a_re; m-tile warp, n-tiles 0 .. NT-1
  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
  for (int s = 0; s < d.nks; ++s) {
    if (s + 1 < d.nks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) Fn[q] = __ldg(fp + ((s + 1) * 4 + q) * 32);
    }
    // rows 8 s + 2 tq (b0) and + 1 (b1) of column 8 n + g
    const float2* ar = a_s + (s * 8 + 2 * tq) * d.sa + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 v0 = ar[n * 8], v1 = ar[d.sa + n * 8];
      const SplitB re = split_b(v0.x, v1.x), im = split_b(v0.y, v1.y);
      mma6(acc[0][n], F[0], F[1], re, F[2], F[3], neg_b(im));
      mma6(acc[1][n], F[0], F[1], im, F[2], F[3], re);
    }
    if (s + 1 < d.nks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) F[q] = Fn[q];
    }
  }
  __syncthreads();  // every warp is done with the spectrum

  // t split into big and small planes over it: re at column c, im at
  // cols + c
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned b0, s0, b1, s1;
        split_tf32(acc[p][n][2 * h], b0, s0);
        split_tf32(acc[p][n][2 * h + 1], b1, s1);
        float* t0 =
            t_s + (warp * 16 + g + 8 * h) * d.st + p * cols + n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(t0) =
            make_float2(__uint_as_float(b0), __uint_as_float(b1));
        *reinterpret_cast<float2*>(t0 + kUTY * d.st) =
            make_float2(__uint_as_float(s0), __uint_as_float(s1));
      }
  __syncthreads();  // t is complete

  // z-unfold: out = [t_re | t_im] [Bz_re; -Bz_im]; item (mh, zg): m-tiles
  // 4 mh .. 4 mh + 3, z n-tiles 4 zg .. 4 zg + 3
  constexpr int nk2 = 2 * NT;
  for (int item = warp; item < 2 * (d.nzt / 4); item += kUWarps) {
    const int mh = item & 1, zg = item >> 1;
    float c[4][4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
    const uint4* bp = bzt + static_cast<size_t>(zg) * 4 * 32 + lane;
    uint4 Bc[4], Bn[4];  // Bz fragments of this k-step and the next
#pragma unroll
    for (int n = 0; n < 4; ++n) Bc[n] = __ldg(bp + n * 32);
    const float* tr = t_s + (mh * 64 + g) * d.st + 2 * tq;
    for (int s = 0; s < nk2; ++s) {
      if (s + 1 < nk2) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          Bn[n] = __ldg(bp + (static_cast<size_t>(s + 1) * d.nzt + n) * 32);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* p = tr + m * 16 * d.st + s * 8;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * d.st);
        const float2 y0 =
            *reinterpret_cast<const float2*>(p + kUTY * d.st);
        const float2 y1 =
            *reinterpret_cast<const float2*>(p + (kUTY + 8) * d.st);
        const uint4 ab =
            make_uint4(__float_as_uint(x0.x), __float_as_uint(x1.x),
                       __float_as_uint(x0.y), __float_as_uint(x1.y));
        const uint4 as =
            make_uint4(__float_as_uint(y0.x), __float_as_uint(y1.x),
                       __float_as_uint(y0.y), __float_as_uint(y1.y));
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(c[m][n], ab, as, SplitB{Bc[n].x, Bc[n].y, Bc[n].z, Bc[n].w});
      }
      if (s + 1 < nk2) {
#pragma unroll
        for (int n = 0; n < 4; ++n) Bc[n] = Bn[n];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = ytile * kUTY + mh * 64 + m * 16 + g + 8 * h;
        if (y >= d.ny) continue;
        float* o = out + (slab * d.ny + y) * d.nz;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int z = (zg * 4 + n) * 8 + 2 * tq;
          if (z < d.nz) o[z] = c[m][n][2 * h];
          if (z + 1 < d.nz) o[z + 1] = c[m][n][2 * h + 1];
        }
      }
  }
}

// K8's first launch: grid (ny rounded up to kLTY, over kLTY; nx) of
// kLThreads, one block per (y-tile, slab x): the y-inverse of the six
// fields, the z-unfold, u x omega and the z-forward, S written split.
// fia, bzt: K7's tables (inverse_tf32_tables) for the instance NT; fzt:
// K6's Fz table (tf32_tables). s: S (3 nx, nchunks, 2, kTN1, nyp) floats.
template <int NT>
__global__ void __launch_bounds__(kLThreads, 1)
lamb_phys_tf32_kernel(const float2* __restrict__ a6,
                      const uint4* __restrict__ fia,
                      const uint4* __restrict__ bzt,
                      const uint4* __restrict__ fzt, float* __restrict__ s,
                      LmDims d, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NH = (NT + 1) / 2;  // Kzc n-tiles of a warp's half
  constexpr int cols = NT * 8;
  const TiDims& e = d.t;
  // the ring: kLStages k-steps of [Fyi fragments][6][8][sa] spectrum rows;
  // after the y-inverse, over it, t [6][kLTY][st], then the products'
  // planes [3][big, small][kLTY][ls]
  const int stage = kLFyi * sizeof(uint4) + 6 * 8 * e.sa * sizeof(float2);
  float* t_s = reinterpret_cast<float*>(smem);
  float* l_s = t_s + 6 * kLTY * e.st;
  const int ytile = blockIdx.x, x = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t spec = static_cast<size_t>(e.ry) * e.kzc;
  const uint4* fim = fia + static_cast<size_t>(ytile) * e.nks * kLFyi;

  // k-step k (Ry rows 8 k .. 8 k + 7) into buffer k % kLStages
  auto load_stage = [&](int k) {
    unsigned char* base = smem + (k % kLStages) * stage;
    uint4* fs = reinterpret_cast<uint4*>(base);
    for (int q = threadIdx.x; q < kLFyi; q += kLThreads)
      cp_async16(smem_u32(fs + q), fim + static_cast<size_t>(k) * kLFyi + q,
                 16);
    float2* as = reinterpret_cast<float2*>(fs + kLFyi);
    if (vec16) {  // Kzc even and a6 16-byte aligned: two complex a copy
      constexpr int ppr = cols / 2;
      for (int q = threadIdx.x; q < 6 * 8 * ppr; q += kLThreads) {
        const int row = q / ppr, c = (q - row * ppr) * 2;  // row = f 8 + i
        const int r = k * 8 + (row & 7);
        const bool ok = r < e.ry && c < e.kzc;
        cp_async16(smem_u32(as + row * e.sa + c),
                   ok ? a6 + ((row >> 3) * d.nx + x) * spec +
                            static_cast<size_t>(r) * e.kzc + c
                      : a6,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < 6 * 8 * cols; q += kLThreads) {
        const int row = q / cols, c = q - row * cols;
        const int r = k * 8 + (row & 7);
        const bool ok = r < e.ry && c < e.kzc;
        cp_async8(smem_u32(as + row * e.sa + c),
                  ok ? a6 + ((row >> 3) * d.nx + x) * spec +
                           static_cast<size_t>(r) * e.kzc + c
                     : a6,
                  ok ? 8 : 0);
      }
    }
  };

  // y-inverse: t_re += Fyi_re a_re + Fyi_im (-a_im), t_im += Fyi_re a_im
  // + Fyi_im a_re; warp (f, h): field f, n-tiles h NH .. h NH + NH - 1
  const int f = warp >> 1, h = warp & 1;
  float acc[2][NH][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < NH; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][i][q] = 0.f;
  // kLStages - 1 k-steps in flight ahead of the one computed, one cp.async
  // group a step (empty past the last), as K6's z-slices
#pragma unroll
  for (int i = 0; i < kLStages - 1; ++i) {
    if (i < e.nks) load_stage(i);
    cp_async_commit();
  }
  for (int k = 0; k < e.nks; ++k) {
    cp_async_wait<kLStages - 2>();
    // step k landed for every thread, and every thread is done with step
    // k - 1, whose buffer the load below refills
    __syncthreads();
    if (k + kLStages - 1 < e.nks) load_stage(k + kLStages - 1);
    cp_async_commit();
    const uint4* fs =
        reinterpret_cast<const uint4*>(smem + (k % kLStages) * stage);
    uint4 F[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) F[q] = fs[q * 32 + lane];
    // rows 2 tq (b0) and 2 tq + 1 (b1) of the step, column 8 n + g
    const float2* ar = reinterpret_cast<const float2*>(fs + kLFyi) +
                       (f * 8 + 2 * tq) * e.sa + g;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int n = h * NH + i;
      if (n < NT) {
        const float2 v0 = ar[n * 8], v1 = ar[e.sa + n * 8];
        const SplitB re = split_b(v0.x, v1.x), im = split_b(v0.y, v1.y);
        mma6(acc[0][i], F[0], F[1], re, F[2], F[3], neg_b(im));
        mma6(acc[1][i], F[0], F[1], im, F[2], F[3], re);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which t overwrites

  // t, unsplit: re at column c, im at cols + c
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int n = h * NH + i;
    if (n < NT) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(t_s + (f * kLTY + g + 8 * r) * e.st +
                                     p * cols + n * 8 + 2 * tq) =
              make_float2(acc[p][i][2 * r], acc[p][i][2 * r + 1]);
    }
  }
  __syncthreads();  // t is complete

  // z-unfold of the six fields, [t_re | t_im] [Bz_re; -Bz_im], and u x
  // omega: in rounds, warp w takes z n-tiles w, w + kLWarps, ... (kLZW of
  // them), their Bz fragments one step ahead; A split as it is loaded
  for (int z0 = 0; z0 < e.nzt; z0 += kLWarps * kLZW) {
    int zt[kLZW];
#pragma unroll
    for (int j = 0; j < kLZW; ++j) zt[j] = z0 + warp + kLWarps * j;
    if (zt[0] >= e.nzt) break;
    float c[6][kLZW][4];
#pragma unroll
    for (int fl = 0; fl < 6; ++fl)
#pragma unroll
      for (int j = 0; j < kLZW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[fl][j][q] = 0.f;
    const uint4* bp = bzt + lane;
    uint4 Bc[kLZW], Bn[kLZW];
#pragma unroll
    for (int j = 0; j < kLZW; ++j)
      if (zt[j] < e.nzt) Bc[j] = __ldg(bp + zt[j] * 32);
    for (int k = 0; k < 2 * NT; ++k) {
      if (k + 1 < 2 * NT) {
#pragma unroll
        for (int j = 0; j < kLZW; ++j)
          if (zt[j] < e.nzt)
            Bn[j] = __ldg(
                bp + (static_cast<size_t>(k + 1) * e.nzt + zt[j]) * 32);
      }
#pragma unroll
      for (int fl = 0; fl < 6; ++fl) {
        const float* p = t_s + (fl * kLTY + g) * e.st + k * 8 + 2 * tq;
        uint4 ab, as;
        split_a(*reinterpret_cast<const float2*>(p),
                *reinterpret_cast<const float2*>(p + 8 * e.st), ab, as);
#pragma unroll
        for (int j = 0; j < kLZW; ++j)
          if (zt[j] < e.nzt)
            mma3(c[fl][j], ab, as, SplitB{Bc[j].x, Bc[j].y, Bc[j].z, Bc[j].w});
      }
      if (k + 1 < 2 * NT) {
#pragma unroll
        for (int j = 0; j < kLZW; ++j) Bc[j] = Bn[j];
      }
    }
    // u x omega in fp32, split into the products' planes
#pragma unroll
    for (int j = 0; j < kLZW; ++j) {
      if (zt[j] >= e.nzt) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned b[3][2], sm[3][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 2 * r + q;
          const float u1 = c[0][j][i], u2 = c[1][j][i], u3 = c[2][j][i];
          const float w1 = c[3][j][i], w2 = c[4][j][i], w3 = c[5][j][i];
          split_tf32(u2 * w3 - u3 * w2, b[0][q], sm[0][q]);
          split_tf32(u3 * w1 - u1 * w3, b[1][q], sm[1][q]);
          split_tf32(u1 * w2 - u2 * w1, b[2][q], sm[2][q]);
        }
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          float* l0 = l_s + (cc * 2 * kLTY + g + 8 * r) * d.ls + zt[j] * 8 +
                      2 * tq;
          *reinterpret_cast<float2*>(l0) = make_float2(
              __uint_as_float(b[cc][0]), __uint_as_float(b[cc][1]));
          *reinterpret_cast<float2*>(l0 + kLTY * d.ls) = make_float2(
              __uint_as_float(sm[cc][0]), __uint_as_float(sm[cc][1]));
        }
      }
    }
  }
  __syncthreads();  // the products are complete

  // z-forward t1 = products @ Fz_chunk^T: item (component, chunk, half):
  // n-tiles 6 half .. 6 half + 5 of the chunk's kTN1 columns (re, then
  // im), Fz's fragments one step ahead; t1 split into S
  for (int it = warp; it < 6 * d.nchunks; it += kLWarps) {
    const int half = it & 1, cc = (it >> 1) % 3, ch = (it >> 1) / 3;
    float o[kBKC / 8][4];
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[n][q] = 0.f;
    const uint4* fp = fzt +
                      (static_cast<size_t>(ch) * e.nzt * (kTN1 / 8) +
                       half * (kBKC / 8)) * 32 + lane;
    uint4 Bc[kBKC / 8], Bn[kBKC / 8];
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n) Bc[n] = __ldg(fp + n * 32);
    const float* lb = l_s + (cc * 2 * kLTY + g) * d.ls + 2 * tq;
    for (int k = 0; k < e.nzt; ++k) {
      if (k + 1 < e.nzt) {
#pragma unroll
        for (int n = 0; n < kBKC / 8; ++n)
          Bn[n] = __ldg(
              fp + (static_cast<size_t>(k + 1) * (kTN1 / 8) + n) * 32);
      }
      const float* p = lb + k * 8;
      const float2 x0 = *reinterpret_cast<const float2*>(p);
      const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * d.ls);
      const float2 y0 = *reinterpret_cast<const float2*>(p + kLTY * d.ls);
      const float2 y1 =
          *reinterpret_cast<const float2*>(p + (kLTY + 8) * d.ls);
      const uint4 ab = make_uint4(__float_as_uint(x0.x), __float_as_uint(x1.x),
                                  __float_as_uint(x0.y), __float_as_uint(x1.y));
      const uint4 as = make_uint4(__float_as_uint(y0.x), __float_as_uint(y1.x),
                                  __float_as_uint(y0.y), __float_as_uint(y1.y));
#pragma unroll
      for (int n = 0; n < kBKC / 8; ++n)
        mma3(o[n], ab, as, SplitB{Bc[n].x, Bc[n].y, Bc[n].z, Bc[n].w});
      if (k + 1 < e.nzt) {
#pragma unroll
        for (int n = 0; n < kBKC / 8; ++n) Bc[n] = Bn[n];
      }
    }
    float* so = s + ((static_cast<size_t>(cc) * d.nx + x) * d.nchunks + ch) *
                        2 * kTN1 * d.nyp;
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = half * kBKC + n * 8 + 2 * tq + (q & 1);
        const int y = ytile * kLTY + g + 8 * (q >> 1);
        unsigned b, sm;
        split_tf32(o[n][q], b, sm);
        so[static_cast<size_t>(col) * d.nyp + y] = __uint_as_float(b);
        so[static_cast<size_t>(kTN1 + col) * d.nyp + y] = __uint_as_float(sm);
      }
  }
}

// K8's second launch: K6's y-stage on S. Grid (nchunks * rparts, 3*nx) of
// kTThreads, one block per (Kzc chunk, part of the Ry rows, component and
// slab), warp w owning row tile rpart kTWarps + w as in K6; each y-tile's
// S planes (kTTY rows of the chunk's kTN1 columns, big and small) arrive
// by cp.async into one of two buffers while the other is used, zero past
// the rows the first launch wrote (ny16).
__global__ void __launch_bounds__(kTThreads, 1)
lamb_yfwd_tf32_kernel(const float* __restrict__ s,
                      const uint4* __restrict__ fya, float* __restrict__ out,
                      TfDims d, int ny16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* t_s = reinterpret_cast<float*>(smem);  // [2][2][kTN1][kTTS]
  const int chunk = blockIdx.x % d.nchunks, rpart = blockIdx.x / d.nchunks;
  const size_t slab = blockIdx.y;  // c * nx + x
  const int nyp = d.nyt * kTTY;
  const float* src = s + (slab * d.nchunks + chunk) * 2 * kTN1 * nyp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  constexpr int cpr = kTTY / 4;  // 16-byte copies a row of a tile
  auto load = [&](int j, int buf) {
    float* dst = t_s + buf * 2 * kTN1 * kTTS;
    for (int q = threadIdx.x; q < 2 * kTN1 * cpr; q += kTThreads) {
      const int row = q / cpr, y = (q - row * cpr) * 4;
      const int yy = j * kTTY + y;
      const bool ok = yy < ny16;
      cp_async16(smem_u32(dst + row * kTTS + y),
                 ok ? src + static_cast<size_t>(row) * nyp + yy : src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  const int yr = rpart * kTWarps + warp;
  const bool act = yr < d.rt;
  float acc[2][kBKC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kBKC / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
  uint4 F[4], Fn[4];  // Fy fragments of this y-step and the next
  auto fetch = [&](int s8, uint4(&fr)[4]) {
    const uint4* p =
        fya + (static_cast<size_t>(s8) * d.rt + yr) * 4 * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) fr[q] = __ldg(p + q * 32);
  };
  load(0, 0);
  for (int j = 0; j < d.nyt; ++j) {
    if (act) fetch(j * (kTTY / 8), F);
    __syncthreads();  // tile j-1's y-stage is done with the other buffer
    if (j + 1 < d.nyt) {
      load(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j landed
    if (act) {
      const float* tb =
          t_s + (j & 1) * 2 * kTN1 * kTTS + g * kTTS + 2 * tq;
#pragma unroll 1
      for (int k = 0; k < kTTY / 8; ++k) {
        fetch(j * (kTTY / 8) + k + 1, Fn);
        y_step_tf32(acc, F, tb + k * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) F[q] = Fn[q];
      }
    }
  }
  if (act) {
    BfDims bd;
    bd.ry = d.ry;
    bd.kzc = d.kzc;
    y_stage_store(acc, out, slab, yr, chunk, bd);
  }
}

// Shared-memory bytes of each kernel; the wrappers' fit check
// (ops/kernels/transform3d_kernels.py::smem_bytes) mirrors these.
inline size_t smem_zy_forward_tf32() {
  return kTStages * kTFz * sizeof(uint4) +
         (kTStages * kTTY * kTWS + 2 * kTN1 * kTTS) * sizeof(float);
}
inline size_t smem_zy_forward_bf16(const BfDims& d) {
  const size_t nzs = d.nzp + 8;
  return 2 * kBTY * nzs * sizeof(float) + kBN1 * nzs * 2 + kBTY * kBTS * 2;
}
inline size_t smem_yz_inverse_tf32(const TiDims& d) {
  return std::max(static_cast<size_t>(d.nks) * 8 * d.sa * sizeof(float2),
                  static_cast<size_t>(2) * kUTY * d.st * sizeof(float));
}
inline size_t smem_lamb_phys_tf32(const LmDims& d) {
  const size_t ring = kLStages * (kLFyi * sizeof(uint4) +
                                  static_cast<size_t>(6) * 8 * d.t.sa *
                                      sizeof(float2));
  const size_t body =
      (static_cast<size_t>(6) * d.t.st + static_cast<size_t>(6) * d.ls) *
      kLTY * sizeof(float);
  return std::max(ring, body);
}
inline size_t smem_lamb_yfwd_tf32() {
  return 2 * 2 * kTN1 * kTTS * sizeof(float);
}
inline size_t smem_yz_inverse_bf16(const VDims& d) {
  return static_cast<size_t>(d.ryp + kVTY) * d.ks * 2;
}
inline size_t smem_lamb_phys_bf16(const VDims& d) {
  const size_t u = std::max(d.ryp * d.ks, 3 * kVTY * d.ls);
  return (u + static_cast<size_t>(6) * kVTY * d.ks) * 2;
}
inline size_t smem_lamb_yfwd_bf16() { return 2 * kBTY * kBTS * 2; }

inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

inline VDims make_vdims(int nx, int ny, int nz, int ry, int kzc) {
  VDims d{nx, ny, nz, ry, kzc};
  d.kp = round_up(kzc, 16);
  d.ryp = round_up(ry, 16);
  d.nzp = round_up(nz, 16);
  d.nyp = round_up(ny, kVTY);
  d.ks = 2 * d.kp + 8;
  d.ls = d.nzp + 8;
  return d;
}

inline TfDims make_tfdims(int ny, int nz, int ry, int kzc) {
  TfDims d;
  d.ny = ny;
  d.nz = nz;
  d.ry = ry;
  d.kzc = kzc;
  d.nsl = (nz + kTKZ - 1) / kTKZ;
  d.rt = (ry + 15) / 16;
  d.nchunks = (kzc + kBKC - 1) / kBKC;
  d.rparts = (d.rt + kTWarps - 1) / kTWarps;
  d.nyt = (ny + kTTY - 1) / kTTY;
  return d;
}

// K7's dims for its instance of nt n-tiles
inline TiDims make_tidims(int ny, int nz, int ry, int kzc, int nt) {
  TiDims d;
  d.ny = ny;
  d.nz = nz;
  d.ry = ry;
  d.kzc = kzc;
  d.ntk = nt;
  d.nks = (ry + 7) / 8;
  d.nzt = round_up(nz, 32) / 8;
  d.sa = round_up(8 * d.ntk, 16) + 2;
  d.st = 16 * d.ntk + 8;
  return d;
}

inline LmDims make_lmdims(int nx, int ny, int nz, int ry, int kzc, int nt) {
  LmDims d;
  d.t = make_tidims(ny, nz, ry, kzc, nt);
  d.nx = nx;
  d.ls = 8 * d.t.nzt + 8;
  d.nchunks = (kzc + kBKC - 1) / kBKC;
  d.nyp = round_up(ny, kTTY);
  return d;
}

inline BfDims make_bfdims(int ny, int nz, int ry, int kzc) {
  BfDims d;
  d.ny = ny;
  d.nz = nz;
  d.ry = ry;
  d.kzc = kzc;
  d.nzp = round_up(nz, 16);
  d.rt = (ry + 15) / 16;
  d.nchunks = (kzc + kBKC - 1) / kBKC;
  d.rparts = (d.rt + kBWarps - 1) / kBWarps;
  d.nyt = (ny + kBTY - 1) / kBTY;
  return d;
}

}  // namespace t3d
}  // namespace ns

extern "C" {

int ns_fused_zy_forward_f32(const void* w, const void* fzt, const void* fya,
                            void* out, int B, int nx, int ny, int nz, int ry,
                            int kzc, void* stream) {
  using namespace ns::t3d;
  const TfDims d = make_tfdims(ny, nz, ry, kzc);
  const int vec16 =
      nz % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = smem_zy_forward_tf32();
  cudaError_t e = ns::allow_smem(zy_forward_tf32_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(d.nchunks * d.rparts, B * nx);
  zy_forward_tf32_kernel<<<grid, kTThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const uint4*>(fzt),
      static_cast<const uint4*>(fya), static_cast<float*>(out), d, vec16);
  return cudaGetLastError();
}

int ns_fused_zy_forward_bf16_f32(const void* w, const void* fzb,
                                 const void* afrag, void* out, int B, int nx,
                                 int ny, int nz, int ry, int kzc,
                                 void* stream) {
  using namespace ns::t3d;
  const BfDims d = make_bfdims(ny, nz, ry, kzc);
  const int vec16 =
      nz % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t smem = smem_zy_forward_bf16(d);
  cudaError_t e = ns::allow_smem(zy_forward_bf16_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(d.nchunks * d.rparts, B * nx);
  zy_forward_bf16_kernel<<<grid, kBThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const uint4*>(fzb),
      static_cast<const uint4*>(afrag), static_cast<float*>(out), d, vec16);
  return cudaGetLastError();
}

int ns_fused_yz_inverse_f32(const void* a, const void* fia, const void* bzt,
                            void* out, int B, int nx, int ny, int nz, int ry,
                            int kzc, void* stream) {
  using namespace ns::t3d;
  int nt = 0;
  for (int n : kUNTs)
    if (!nt && 8 * n >= kzc) nt = n;
  if (!nt) return cudaErrorInvalidValue;
  const TiDims d = make_tidims(ny, nz, ry, kzc, nt);
  const int vec16 =
      kzc % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const size_t smem = smem_yz_inverse_tf32(d);
  const dim3 grid(B * nx, (ny + kUTY - 1) / kUTY);
  auto launch = [&](auto kernel) {
    cudaError_t e = ns::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kUThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(a), static_cast<const uint4*>(fia),
        static_cast<const uint4*>(bzt), static_cast<float*>(out), d, vec16);
    return cudaGetLastError();
  };
  switch (nt) {
    case 3: return launch(yz_inverse_tf32_kernel<3>);
    case 6: return launch(yz_inverse_tf32_kernel<6>);
    case 11: return launch(yz_inverse_tf32_kernel<11>);
    default: return launch(yz_inverse_tf32_kernel<13>);
  }
}

// fia, bzt: inverse_tf32_tables; fzt, fya: tf32_tables; scratch: S (3 nx,
// nchunks, 2, kTN1, ny rounded up to kTTY) floats
int ns_fused_lamb_f32(const void* a6, const void* fia, const void* bzt,
                      const void* fzt, const void* fya, void* scratch,
                      void* out, int nx, int ny, int nz, int ry, int kzc,
                      void* stream) {
  using namespace ns::t3d;
  int nt = 0;
  for (int n : kUNTs)
    if (!nt && 8 * n >= kzc) nt = n;
  if (!nt) return cudaErrorInvalidValue;
  const LmDims d = make_lmdims(nx, ny, nz, ry, kzc, nt);
  const TfDims f = make_tfdims(ny, nz, ry, kzc);
  const int ny16 = round_up(ny, kLTY);
  const int vec16 =
      kzc % 2 == 0 && reinterpret_cast<uintptr_t>(a6) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = smem_lamb_phys_tf32(d), smem2 = smem_lamb_yfwd_tf32();
  auto launch = [&](auto kernel) {
    cudaError_t e = ns::allow_smem(kernel, smem1);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(ny16 / kLTY, nx), kLThreads, smem1, st>>>(
        static_cast<const float2*>(a6), static_cast<const uint4*>(fia),
        static_cast<const uint4*>(bzt), static_cast<const uint4*>(fzt),
        static_cast<float*>(scratch), d, vec16);
    return cudaGetLastError();
  };
  cudaError_t e;
  switch (nt) {
    case 3: e = launch(lamb_phys_tf32_kernel<3>); break;
    case 6: e = launch(lamb_phys_tf32_kernel<6>); break;
    case 11: e = launch(lamb_phys_tf32_kernel<11>); break;
    default: e = launch(lamb_phys_tf32_kernel<13>); break;
  }
  if (e != cudaSuccess) return e;
  e = ns::allow_smem(lamb_yfwd_tf32_kernel, smem2);
  if (e != cudaSuccess) return e;
  lamb_yfwd_tf32_kernel<<<dim3(f.nchunks * f.rparts, 3 * nx), kTThreads,
                          smem2, st>>>(
      static_cast<const float*>(scratch), static_cast<const uint4*>(fya),
      static_cast<float*>(out), f, ny16);
  return cudaGetLastError();
}

int ns_fused_yz_inverse_bf16_f32(const void* a, const void* afi,
                                 const void* bzf, void* out, int B, int nx,
                                 int ny, int nz, int ry, int kzc,
                                 void* stream) {
  using namespace ns::t3d;
  const VDims d = make_vdims(nx, ny, nz, ry, kzc);
  const size_t smem = smem_yz_inverse_bf16(d);
  cudaError_t e = ns::allow_smem(yz_inverse_bf16_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * nx, d.nyp / kVTY);
  yz_inverse_bf16_kernel<<<grid, kVThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const uint4*>(afi),
      static_cast<const uint4*>(bzf), static_cast<float*>(out), d);
  return cudaGetLastError();
}

// scratch: s (3, nx, nyp, 2 kp) bf16
int ns_fused_lamb_bf16_f32(const void* a6, const void* afi, const void* bzf,
                           const void* fzf, const void* afrag, void* scratch,
                           void* out, int nx, int ny, int nz, int ry, int kzc,
                           void* stream) {
  using namespace ns::t3d;
  const VDims d = make_vdims(nx, ny, nz, ry, kzc);
  const BfDims b = make_bfdims(ny, nz, ry, kzc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = smem_lamb_phys_bf16(d), smem2 = smem_lamb_yfwd_bf16();
  cudaError_t e = ns::allow_smem(lamb_phys_bf16_kernel, smem1);
  if (e != cudaSuccess) return e;
  e = ns::allow_smem(lamb_yfwd_bf16_kernel, smem2);
  if (e != cudaSuccess) return e;
  lamb_phys_bf16_kernel<<<dim3(nx, d.nyp / kVTY), kVThreads, smem1, st>>>(
      static_cast<const float2*>(a6), static_cast<const uint4*>(afi),
      static_cast<const uint4*>(bzf), static_cast<const uint4*>(fzf),
      static_cast<unsigned short*>(scratch), d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lamb_yfwd_bf16_kernel<<<dim3(b.nchunks * b.rparts, 3 * nx), kBThreads,
                          smem2, st>>>(
      static_cast<const unsigned short*>(scratch),
      static_cast<const uint4*>(afrag), static_cast<float*>(out), b, d.kp);
  return cudaGetLastError();
}

}  // extern "C"
