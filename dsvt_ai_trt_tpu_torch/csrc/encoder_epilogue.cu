// Kernel B2: the fused DSVT encoder epilogue.
//
// Replaces: dsvt_ai_trt_tpu/ops/encoder_pallas.py:encoder_epilogue (Pallas
// body _epilogue_kernel).
//
// Contract: x [P, C] f32, a [P, C] bf16, the weights wo [C, C], w1 [C, F],
// w2 [F, C] bf16 in the panel layout below, bo [C], b1 [F], b2 [C] f32,
// ln [6, C] f32 = (g1, b1, g2, b2, g3, b3) -> out [P, C] f32:
//   attn = a@wo + bo;  x1 = LN(x + attn);
//   x2 = LN(x1 + gelu_tanh(x1@w1 + b1)@w2 + b2);  out = LN(x2 + x).
// LN: population variance, eps as given.  Matmul inputs bf16 (x1 and the
// GELU output are rounded to bf16 before their products, as on the TPU),
// accumulation and everything else f32.  C a multiple of 32 up to 256, F a
// multiple of C.
//
// Weight layout (ops/encoder_kernel.py:kernel_weights, made once): W [K, N]
// is stored as [N/C][K/32][C][32] -- panels of C output columns, each cut
// into k-slabs of 32 rows stored transposed (column n's 32 k values
// contiguous), so one slab is one contiguous C*64-byte block and the B
// fragments of mma.sync come from it by plain ldmatrix.  The kernel reads
// wo's C/32 slabs, w1's F/32 and w2's F/32 as one stream.
//
// What bounds it on the H100: bytes, narrowly.  At P=10000, C=192, F=384
// it moves 19.2 MB (x and out f32, a bf16) plus 0.37 MB of weights (5.8 us
// at 3.35 TB/s) and does 3.69 GFLOP of bf16 products (3.7 us at
// 989 TFLOP/s).  Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.044 ms
// device-only, 13% of the bytes bound.
//
// Design: one block of 8 warps per tile of 64 rows (157 tiles at P=10000).
// The weights never feed a product from global memory: the slab stream goes
// through a 2-stage ring in shared memory by 16-byte cp.async, slab i+1 in
// flight while slab i multiplies, across product boundaries too (the first
// slab of w1 lands while the LayerNorm after wo runs), with one barrier per
// slab.  The products run on mma.sync m16n8k16 (bf16, f32 accumulators) with
// A and B fragments from ldmatrix; the 8 warps split the 64 x C output 2 x
// 4, so each holds a 32 x C/4 accumulator (48 registers at C=192).  w1's F
// columns go in F/C panels of C, so one accumulator shape serves all three
// products and the GELU output leaves each panel as bf16 in shared memory,
// the A operand of w2.  x1 stays f32 in registers for its residual; x is
// read from global memory (L2) at the first and last LayerNorm, not kept.
// LayerNorm rows reduce by quad shuffles within a warp and a 64 x 4 exchange
// in shared memory across the 4 warps of a row. Shared memory at C=192,
// F=384: a/x1 operand 25.6 KB + GELU operand 50.2 KB + ring 30.7 KB +
// exchange 2 KB = 106 KB, so 2 blocks (16 warps) per SM and all 157 tiles
// resident in one wave on 132 SMs; the 25 SMs that hold two tiles set the
// tail.  At the 128-register cap of 2 blocks per SM, C=192 spills 104 bytes
// a thread.  What bounds it now (same run): one tile's own latency, not the
// SMs' throughput -- one 64-row tile alone takes 0.030 ms, one tile per SM
// 0.035 ms, two per SM 0.053 ms.  A persistent variant (one block per SM, a
// 6-stage ring with 5 slabs in flight, the next tile's a rows
// double-buffered) measured 0.064 ms against this design's 0.044: it runs
// the two tiles of the busiest SMs back to back, and the deeper ring did not
// shorten a tile, so the slab wait is not what a tile waits on; where its
// time goes is not yet traced.  The products stay on mma.sync: wgmma would
// want the operand tiles and slabs in its swizzled shared-memory layouts,
// later work.  Rows past P are zero-filled on load and never written.  No
// cuBLAS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int BM = 64;        // rows per tile
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int BK = 32;        // k rows per weight slab
constexpr int SP = BK + 8;    // bf16 pitch of a staged slab row

__device__ __forceinline__ float gelu_tanh(float x) {
  const float a = 0.5f, b = 0.7978845608028654f, c = 0.035677408136300125f;
  return (a + a * tanhf(x * (c * x * x + b))) * x;
}

// Fragment coordinates of this thread: element e of n-tile j in m-tile mi
// sits at tile row wm*32 + mi*16 + g + (e/2)*8, column wn*C/4 + j*8 + 2t +
// e%2.
struct Frag {
  int wm, wn, g, t;
  __device__ int row(int mi, int half) const {
    return wm * 32 + mi * 16 + half * 8 + g;
  }
  __device__ int col(int NTW, int j) const {
    return wn * NTW * 8 + j * 8 + 2 * t;
  }
};

// acc = A[:, 0:kslabs*BK] @ the next kslabs slabs of the stream.  A is bf16
// in shared memory with pitch lda.  Per slab: wait for it, one barrier
// (after which every warp is done with the other stage), issue the next
// slab into the other stage, multiply.  An epilogue that writes an operand
// tile after a product relies on the barrier inside layer_norm, or on the
// next product's first barrier, to order it after the product's reads.
template <int NTW, typename Issue>
__device__ __forceinline__ void product(float (&acc)[2][NTW][4],
                                        const __nv_bfloat16* sop, int lda,
                                        int kslabs, int& slab, int n_slabs,
                                        const __nv_bfloat16* ring,
                                        const Frag& f, int lane,
                                        Issue&& issue) {
  constexpr int C = 32 * NTW;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0f;
  for (int ks = 0; ks < kslabs; ++ks, ++slab) {
    cp_async_wait<0>();  // slab `slab` (the newest group) has landed
    __syncthreads();
    if (slab + 1 < n_slabs) issue(slab + 1);
    cp_async_commit();
    const __nv_bfloat16* w = ring + (slab & 1) * C * SP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi],
                smem_u32(sop + (f.wm * 32 + mi * 16 + (lane & 15)) * lda +
                         ks * BK + kk + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        const int n = f.wn * NTW * 8 + j * 8 + (lane & 7);
        const int k = kk + ((lane >> 3) & 1) * 8;
        if (j + 1 < NTW) {  // two n-tiles from one x4
          uint32_t b[4];
          ldsm_x4(b, smem_u32(w + (n + ((lane >> 4) << 3)) * SP + k));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][j], af[mi], b[0], b[1]);
            mma_16816(acc[mi][j + 1], af[mi], b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ldsm_x2(b, smem_u32(w + n * SP + k));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_16816(acc[mi][j], af[mi], b[0], b[1]);
        }
      }
    }
  }
}

// v = LN(v) * gamma + beta over the C columns of each tile row.  `red`
// holds 2 x BM x 4 floats: per row, one partial from each column warp.
template <int NTW>
__device__ __forceinline__ void layer_norm(float (&v)[2][NTW][4],
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float eps, float* red,
                                           const Frag& f) {
  constexpr int C = 32 * NTW;
  float mean[2][2], rstd[2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // 0: sum, 1: squared deviations
    float* part = red + pass * BM * 4;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 2 * half; e < 2 * half + 2; ++e) {
            const float d = pass ? v[mi][j][e] - mean[mi][half] : v[mi][j][e];
            s += pass ? d * d : d;
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (f.t == 0) part[f.row(mi, half) * 4 + f.wn] = s;
      }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* q = part + f.row(mi, half) * 4;
        const float tot = (q[0] + q[1]) + (q[2] + q[3]);
        if (pass == 0)
          mean[mi][half] = tot / C;
        else
          rstd[mi][half] = rsqrtf(tot / C + eps);
      }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int c = f.col(NTW, j);
      const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
      const float2 bt = *reinterpret_cast<const float2*>(beta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        v[mi][j][e] = (v[mi][j][e] - mean[mi][half]) * rstd[mi][half] *
                          (e & 1 ? gm.y : gm.x) +
                      (e & 1 ? bt.y : bt.x);
      }
    }
}

// v += x over the tile (rows past P read as 0)
template <int NTW>
__device__ __forceinline__ void add_x(float (&v)[2][NTW][4],
                                      const float* __restrict__ x, int row0,
                                      int P, const Frag& f) {
  constexpr int C = 32 * NTW;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + f.row(mi, half);
      if (r >= P) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float2 xv = __ldg(reinterpret_cast<const float2*>(
            x + (size_t)r * C + f.col(NTW, j)));
        v[mi][j][2 * half] += xv.x;
        v[mi][j][2 * half + 1] += xv.y;
      }
    }
}

// v (f32 fragments) -> bf16 operand tile in shared memory at column c0
template <int NTW>
__device__ __forceinline__ void store_operand(const float (&v)[2][NTW][4],
                                              __nv_bfloat16* sop, int ld,
                                              int c0, const Frag& f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(sop + f.row(mi, half) * ld + c0 +
                                     f.col(NTW, j)) =
            pack_bf16(v[mi][j][2 * half], v[mi][j][2 * half + 1]);
}

template <int NTW>
__global__ void __launch_bounds__(THREADS, 2)
encoder_epilogue_kernel(const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ wo,
                        const float* __restrict__ bo,
                        const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ ln, float* __restrict__ out,
                        int P, int F, float eps) {
  constexpr int C = 32 * NTW;
  constexpr int LDA = C + 8;  // bf16 pitch of the a / x1 operand tile
  const int ldh = F + 8;      // bf16 pitch of the GELU operand tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sH = sA + BM * LDA;
  __nv_bfloat16* ring = sH + BM * ldh;
  float* red = reinterpret_cast<float*>(ring + 2 * C * SP);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const Frag f{warp / 4, warp % 4, lane / 4, lane % 4};
  const int row0 = blockIdx.x * BM;
  const int n_wo = C / BK, n_w1 = F / BK;
  const int n_slabs = n_wo + 2 * n_w1;

  auto issue = [&](int s) {  // slab s of the stream -> ring stage s % 2
    const __nv_bfloat16* src =
        s < n_wo ? wo + (size_t)s * C * BK
                 : (s < n_wo + n_w1 ? w1 + (size_t)(s - n_wo) * C * BK
                                    : w2 + (size_t)(s - n_wo - n_w1) * C * BK);
    const uint32_t dst = smem_u32(ring + (s & 1) * C * SP);
    for (int i = threadIdx.x; i < C * BK / 8; i += THREADS)
      cp_async16(dst + ((i / 4) * SP + (i % 4) * 8) * 2, src + i * 8);
  };

  // the a tile (rows past P zero-filled) and the first slab: one group
  for (int i = threadIdx.x; i < BM * C / 8; i += THREADS) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const bool in = row0 + r < P;
    cp_async16(smem_u32(sA + r * LDA + c),
               a + (size_t)(in ? row0 + r : 0) * C + c, in);
  }
  issue(0);
  cp_async_commit();
  int slab = 0;

  float acc[2][NTW][4];
  float x1[2][NTW][4];

  // x1 = LN(x + (a@wo + bo)); its bf16 copy replaces a as the operand
  product<NTW>(acc, sA, LDA, n_wo, slab, n_slabs, ring, f, lane, issue);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bo + f.col(NTW, j));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x1[mi][j][e] = acc[mi][j][e] + (e & 1 ? bv.y : bv.x);
    }
  add_x<NTW>(x1, x, row0, P, f);
  layer_norm<NTW>(x1, ln, ln + C, eps, red, f);  // its barrier: a is read
  store_operand<NTW>(x1, sA, LDA, 0, f);

  // h = gelu(x1@w1 + b1), one panel of C columns at a time -> sH (bf16)
  for (int p = 0; p < F / C; ++p) {
    product<NTW>(acc, sA, LDA, n_wo, slab, n_slabs, ring, f, lane, issue);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(b1 + p * C + f.col(NTW, j));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] = gelu_tanh(acc[mi][j][e] + (e & 1 ? bv.y : bv.x));
      }
    store_operand<NTW>(acc, sH, ldh, p * C, f);
  }

  // x2 = LN(x1 + (h@w2 + b2)); out = LN(x2 + x)
  product<NTW>(acc, sH, ldh, n_w1, slab, n_slabs, ring, f, lane, issue);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(b2 + f.col(NTW, j));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][j][e] =
            x1[mi][j][e] + (acc[mi][j][e] + (e & 1 ? bv.y : bv.x));
    }
  layer_norm<NTW>(acc, ln + 2 * C, ln + 3 * C, eps, red, f);
  add_x<NTW>(acc, x, row0, P, f);
  layer_norm<NTW>(acc, ln + 4 * C, ln + 5 * C, eps, red, f);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + f.row(mi, half);
      if (r >= P) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * C + f.col(NTW, j)) =
            make_float2(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
    }
}

template <int NTW>
int launch(const void* x, const void* a, const void* wo, const void* bo,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* ln, void* out, int P, int F, float eps,
           cudaStream_t stream) {
  constexpr int C = 32 * NTW;
  const int smem =
      (BM * (C + 8) + BM * (F + 8) + 2 * C * SP) * 2 + 2 * BM * 4 * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;  // dynamic shared memory already allowed
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        encoder_epilogue_kernel<NTW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(encoder_epilogue_kernel<NTW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  encoder_epilogue_kernel<NTW><<<(P + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ln), static_cast<float*>(out), P, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsvt_encoder_epilogue(const void* x, const void* a,
                                     const void* wo, const void* bo,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2,
                                     const void* ln, void* out, int P, int C,
                                     int F, float eps, void* stream) {
  if (P < 1 || C < 32 || C > 256 || C % 32 || F < C || F % C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSVT_B2_CASE(n)                                                     \
  case n:                                                                   \
    return launch<n>(x, a, wo, bo, w1, b1, w2, b2, ln, out, P, F, eps, st);
  switch (C / 32) {
    DSVT_B2_CASE(1)
    DSVT_B2_CASE(2)
    DSVT_B2_CASE(3)
    DSVT_B2_CASE(4)
    DSVT_B2_CASE(5)
    DSVT_B2_CASE(6)
    DSVT_B2_CASE(7)
    DSVT_B2_CASE(8)
  }
#undef DSVT_B2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
