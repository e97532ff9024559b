// Kernel B2: the fused DSVT encoder epilogue.
//
// Replaces: dsvt_ai_trt_tpu/ops/encoder_pallas.py:encoder_epilogue (Pallas
// body _epilogue_kernel).
//
// Contract: x [P, C] f32, a [P, C] bf16, wo [C, C], w1 [C, F], w2 [F, C]
// bf16 (row-major, x @ w), bo [C], b1 [F], b2 [C] f32, ln [6, C] f32 =
// (g1, b1, g2, b2, g3, b3) -> out [P, C] f32:
//   attn = a@wo + bo;  x1 = LN(x + attn);
//   x2 = LN(x1 + gelu_tanh(x1@w1 + b1)@w2 + b2);  out = LN(x2 + x).
// LN: population variance, eps as given.  Matmul inputs bf16 (x1 and the
// GELU output are rounded to bf16 before their products, as on the TPU),
// accumulation and everything else f32.
//
// What bounds it on the H100: bytes, narrowly.  At P=10000, C=192, F=384
// it moves 19 MB (x and out f32, a bf16; ~5.7 us at 3.35 TB/s) and does
// 3.7 GFLOP of bf16 products (~3.7 us at 989 TFLOP/s).
//
// Design: one block of 8 warps per tile of 32 rows.  The row tile and
// every intermediate stay in shared memory (x, x1, an f32 accumulator tile
// and a bf16 operand tile, ~122 KB), so the only device-memory traffic is
// one read of x and a, one write of out, and the three weight matrices,
// which all blocks share from L2.  The three products run on the tensor
// cores as 16x16x16 bf16 WMMA tiles with f32 accumulators (B fragments
// read straight from the L2-resident weights); each warp owns whole 16x16
// output tiles.  LayerNorms run one warp per row with shuffle reductions.
// Rows past P are zero in shared memory and never written.  No cuBLAS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;       // rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out[c] = (in[c] - mean) * rsqrt(var + eps) * g[c] + b[c] over one row;
// `in` may alias `out` (each lane rewrites only the entries it read)
__device__ void ln_row(const float* in, float* out, const float* g,
                       const float* b, int C, float eps, int lane) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += in[c];
  const float mean = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = in[c] - mean;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
  for (int c = lane; c < C; c += 32) out[c] = (in[c] - mean) * r * g[c] + b[c];
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float a = 0.5f, b = 0.7978845608028654f, c = 0.035677408136300125f;
  return (a + a * tanhf(x * (c * x * x + b))) * x;
}

// acc[BM, N] = A[BM, Kd] (bf16, shared) @ W[Kd, N] (bf16, global)
__device__ void tile_matmul(const __nv_bfloat16* sA, int lda,
                            const __nv_bfloat16* __restrict__ w, int Kd, int N,
                            float* sAcc, int ldacc, int warp) {
  const int tn = N / 16;
  for (int t = warp; t < (BM / 16) * tn; t += WARPS) {
    const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < Kd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sA + m0 * lda + k0, lda);
      wmma::load_matrix_sync(fb, w + (size_t)k0 * N + n0, N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sAcc + m0 * ldacc + n0, acc, ldacc,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS)
encoder_epilogue_kernel(const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ wo,
                        const float* __restrict__ bo,
                        const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ ln, float* __restrict__ out,
                        int P, int C, int F, float eps) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int N = C > F ? C : F;
  const int ldx = C + 4;     // f32 row pitch of x / x1 tiles
  const int ldacc = N + 4;   // f32 row pitch of the accumulator tile
  const int lda = N + 8;     // bf16 row pitch of the operand tile
  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sX1 = sX + BM * ldx;
  float* sAcc = sX1 + BM * ldx;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(sAcc + BM * ldacc);

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t = threadIdx.x; t < BM * C; t += THREADS) {
    const int r = t / C, c = t - r * C;
    const bool in = row0 + r < P;
    const size_t g = (size_t)(row0 + r) * C + c;
    sX[r * ldx + c] = in ? x[g] : 0.0f;
    sA[r * lda + c] = in ? a[g] : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  // attn = a @ wo
  tile_matmul(sA, lda, wo, C, C, sAcc, ldacc, warp);
  __syncthreads();

  // x1 = LN(x + attn + bo) -> sX1 (f32) and sA (bf16 operand)
  for (int r = warp; r < BM; r += WARPS) {
    float* h = sAcc + r * ldacc;
    for (int c = lane; c < C; c += 32) h[c] += sX[r * ldx + c] + bo[c];
    __syncwarp();
    ln_row(h, sX1 + r * ldx, ln, ln + C, C, eps, lane);
    __syncwarp();
    for (int c = lane; c < C; c += 32)
      sA[r * lda + c] = __float2bfloat16_rn(sX1[r * ldx + c]);
  }
  __syncthreads();

  // h = gelu(x1 @ w1 + b1) -> sA (bf16)
  tile_matmul(sA, lda, w1, C, F, sAcc, ldacc, warp);
  __syncthreads();
  for (int t = threadIdx.x; t < BM * F; t += THREADS) {
    const int r = t / F, c = t - r * F;
    sA[r * lda + c] = __float2bfloat16_rn(gelu_tanh(sAcc[r * ldacc + c] + b1[c]));
  }
  __syncthreads();

  // f = h @ w2
  tile_matmul(sA, lda, w2, F, C, sAcc, ldacc, warp);
  __syncthreads();

  // x2 = LN(x1 + f + b2); out = LN(x2 + x)
  for (int r = warp; r < BM; r += WARPS) {
    float* h = sAcc + r * ldacc;
    for (int c = lane; c < C; c += 32) h[c] += sX1[r * ldx + c] + b2[c];
    __syncwarp();
    ln_row(h, h, ln + 2 * C, ln + 3 * C, C, eps, lane);
    __syncwarp();
    for (int c = lane; c < C; c += 32) h[c] += sX[r * ldx + c];
    __syncwarp();
    if (row0 + r < P)
      ln_row(h, out + (size_t)(row0 + r) * C, ln + 4 * C, ln + 5 * C, C, eps,
             lane);
  }
}

}  // namespace

extern "C" int dsvt_encoder_epilogue(const void* x, const void* a,
                                     const void* wo, const void* bo,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2,
                                     const void* ln, void* out, int P, int C,
                                     int F, float eps, void* stream) {
  const int N = C > F ? C : F;
  const size_t smem = (size_t)BM * (C + 4) * 4 * 2 + (size_t)BM * (N + 4) * 4 +
                      (size_t)BM * (N + 8) * 2;
  if (smem > 227 * 1024 || C % 16 || F % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (P + BM - 1) / BM;
  encoder_epilogue_kernel<<<blocks, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ln), static_cast<float*>(out), P, C, F, eps);
  return static_cast<int>(cudaGetLastError());
}
