// Kernel B1: masked multi-head set attention over a flat gathered table.
//
// Replaces: dsvt_ai_trt_tpu/ops/attention_pallas.py:set_attention_fused_flat
// (Pallas bodies _attn_kernel_pairs and _attn_block_math).
//
// Contract: qkv [S*K, 3C] bf16 (row = set*K + slot, q | k | v on the
// channel axis, head h on channels [h*D, (h+1)*D) of each third), mask
// [S, K] f32 additive (a key is live iff mask >= 0), count [1] int32 ->
// out [S*K, C] bf16.  Scale 1/sqrt(D), f32 softmax with its max taken per
// (head, set) -- never one max across heads, which underflowed whole heads
// on the TPU.  Dead keys contribute nothing: their weight is exactly 0 in
// both the weighted V sum and the row sum.  A set with no live key, and
// every set >= count, writes exact zeros.
//
// What bounds it on the H100: bytes.  At S=800, K=36, C=192 it reads the
// 33 MB gathered table and writes 11 MB (~13 us at 3.35 TB/s); the math,
// 4*H*K*K*D = 1 MFLOP per set, is far below the tensor-core line.
//
// Design: one block per set.  The block copies its set's [K, 3C] rows into
// shared memory with 16-byte loads (rows padded to an odd word count so
// that threads reading one column of different rows hit different banks),
// computes all H [K, K] logit tiles into shared memory, runs one warp per
// (head, query) row for the masked softmax (max and sum by warp shuffles),
// then forms each output channel as the probability-weighted sum of the V
// column.  Sets >= count skip all of it and write zeros, as the TPU
// kernel's occupancy gate did.  Math is f32 on CUDA cores: a simple kernel
// that is right comes first; mma/wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ const __nv_bfloat16* row_ptr(const uint32_t* tile,
                                                        int rw, int r) {
  return reinterpret_cast<const __nv_bfloat16*>(tile + (size_t)r * rw);
}

__global__ void __launch_bounds__(THREADS)
set_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ mask,
                     const int* __restrict__ count,
                     __nv_bfloat16* __restrict__ out, int K, int C, int H) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int s = blockIdx.x;
  const int D = C / H;
  const int C3 = 3 * C;
  const int rw = C3 / 2 + 1;  // 32-bit words per shared row (odd)
  uint32_t* tile = smem;                                        // K * rw
  float* logit = reinterpret_cast<float*>(tile + (size_t)K * rw);  // H*K*K
  float* rinv = logit + (size_t)H * K * K;                      // H*K
  int* live = reinterpret_cast<int*>(rinv + H * K);             // K

  __nv_bfloat16* o = out + (size_t)s * K * C;
  if (s >= *count) {  // occupancy gate: invalid sets are zeros
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int t = threadIdx.x; t < K * C / 8; t += THREADS)
      o4[t] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // stage the set's rows: 16-byte global loads, 4-byte shared stores
  const uint4* src = reinterpret_cast<const uint4*>(qkv + (size_t)s * K * C3);
  const int vpr = C3 / 8;  // uint4 vectors per row
  for (int t = threadIdx.x; t < K * vpr; t += THREADS) {
    const int r = t / vpr, cv = t - r * vpr;
    const uint4 v = src[t];
    uint32_t* dst = tile + (size_t)r * rw + cv * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  for (int j = threadIdx.x; j < K; j += THREADS)
    live[j] = mask[(size_t)s * K + j] >= 0.0f;
  __syncthreads();

  // logits[h][i][j] = scale * q_i . k_j over head h; dead keys -inf
  const float scale = 1.0f / sqrtf((float)D);
  const int KK = K * K;
  for (int t = threadIdx.x; t < H * KK; t += THREADS) {
    const int h = t / KK;
    const int i = (t / K) % K;
    const int j = t % K;
    float acc = -INFINITY;
    if (live[j]) {
      const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(
          row_ptr(tile, rw, i) + h * D);
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(
          row_ptr(tile, rw, j) + C + h * D);
      float sum = 0.0f;
      for (int d = 0; d < D / 2; ++d) {
        const float2 a = __bfloat1622float2(qp[d]);
        const float2 b = __bfloat1622float2(kp[d]);
        sum = fmaf(a.x, b.x, sum);
        sum = fmaf(a.y, b.y, sum);
      }
      acc = sum * scale;
    }
    logit[t] = acc;
  }
  __syncthreads();

  // masked softmax per (head, query) row: one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < H * K; row += THREADS / 32) {
    float* lr = logit + (size_t)row * K;
    float m = -INFINITY;
    for (int j = lane; j < K; j += 32) m = fmaxf(m, lr[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < K; j += 32) {
      const float e = (m == -INFINITY) ? 0.0f : expf(lr[j] - m);
      lr[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) rinv[row] = sum > 0.0f ? 1.0f / sum : 0.0f;
  }
  __syncthreads();

  // out[i][c] = rinv * sum_j e[h(c)][i][j] * v[j][c]
  for (int t = threadIdx.x; t < K * C; t += THREADS) {
    const int i = t / C, c = t - i * C, h = c / D;
    const float* pr = logit + ((size_t)h * K + i) * K;
    float acc = 0.0f;
    for (int j = 0; j < K; ++j)
      acc = fmaf(pr[j], __bfloat162float(row_ptr(tile, rw, j)[2 * C + c]),
                 acc);
    o[t] = __float2bfloat16_rn(acc * rinv[h * K + i]);
  }
}

}  // namespace

extern "C" int dsvt_set_attention(const void* qkv, const void* mask,
                                  const void* count, void* out, int S, int K,
                                  int C, int H, void* stream) {
  const size_t rw = (size_t)3 * C / 2 + 1;
  const size_t smem =
      ((size_t)K * rw + (size_t)H * K * K + (size_t)H * K + K) * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      set_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  set_attention_kernel<<<S, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(mask),
      static_cast<const int*>(count), static_cast<__nv_bfloat16*>(out), K, C,
      H);
  return static_cast<int>(cudaGetLastError());
}
