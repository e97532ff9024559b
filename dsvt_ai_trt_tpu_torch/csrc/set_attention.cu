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
// both the weighted V sum and the row sum.  The unnormalised weights are
// rounded to bf16 for the V product, as the Pallas kernel does; the row sum
// and the 1/sum scale stay f32.  A set with no live key, and every set >=
// count, writes exact zeros.  K <= 64, D a multiple of 8.
//
// What bounds it on the H100: bytes.  At S=800, K=36, C=192 with 588 live
// sets it reads 24.4 MB of the table and writes 11.1 MB (10.6 us at
// 3.35 TB/s); the math, 4*H*K*K*D = 1 MFLOP per set, is far below the
// tensor-core line.  Measured (chip_smoke.py, H100 80GB HBM3, 700 W):
// 0.023 ms device-only, 46% of the bytes bound, against 0.17 ms for
// PyTorch's scaled_dot_product_attention on the same inputs.
//
// Design: persistent blocks of 8 warps, two per SM, each walking the live
// sets with stride gridDim.x.  A set's [K, 3C] rows are one contiguous box
// of the table; the block copies them into shared memory with 16-byte
// cp.async (rows padded by 16 bytes, so the 8 row addresses of an ldmatrix
// hit distinct banks) into a ring of 2 stages, and the next set's copy is
// in flight while the current one computes (2 x 42 KB a block at K=36,
// C=192: 2 blocks, 16 warps, per SM).  One warp per (head, 16-query
// m-tile): Q.K^T on mma.sync m16n8k16 over the head's channels, the last
// 8 channels of a D=24 head on m16n8k8 so that no channel of head h+1
// enters the dot; keys in n-tiles of 8 (36 -> 40), queries in m-tiles of
// 16 (36 -> 48).  Rows past K are never stored: ldmatrix addresses of pad
// queries and pad keys are clamped to row K-1, pad keys are masked like
// dead ones and pad query rows are not written.  The softmax runs on the
// accumulator fragments in registers (quad shuffles for the row max and
// sum); the f32 weights become bf16 A fragments of P.V in place (the
// FlashAttention-2 register reuse), V's B fragments come from
// ldmatrix.trans, and no logit touches shared or global memory.  The
// output is scaled by 1/sum, staged as bf16 over the head's own Q columns
// (read by no other warp) and leaves with 16-byte stores.  Sets >= count
// are loaded not at all: every block writes a share of their zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;
constexpr int MAX_K = 64;

// One warp: head h, queries [16*mt, 16*mt + 16) of the staged set.  NT key
// n-tiles of 8 cover the K keys.
template <int NT>
__device__ __forceinline__ void attend(unsigned char* tile, int pitch,
                                       uint64_t live, int h, int mt, int K,
                                       int C, int D, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t base = smem_u32(tile);
  const int last = K - 1;
  const uint32_t qaddr =
      base + min(mt * 16 + (lane & 15), last) * pitch + h * D * 2;
  const int kcol = C + h * D;

  float sacc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;

  int d0 = 0;
  for (; d0 + 16 <= D; d0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, qaddr + d0 * 2 + (lane >> 4) * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      ldsm_x2(b, base + min(j * 8 + (lane & 7), last) * pitch +
                     (kcol + d0) * 2 + ((lane >> 3) & 1) * 16);
      mma_16816(sacc[j], a, b[0], b[1]);
    }
  }
  if (d0 < D) {  // the head's last 8 channels: k8, never head h+1's
    uint32_t a[2];
    ldsm_x2(a, qaddr + d0 * 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t b =
          ldsm_x1(base + min(j * 8 + (lane & 7), last) * pitch +
                  (kcol + d0) * 2);
      mma_1688(sacc[j], a[0], a[1], b);
    }
  }

  // masked softmax on the fragments: rows g (e = 0, 1) and g+8 (e = 2, 3)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      sacc[j][e] = ((live >> key) & 1) ? sacc[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  float sum[2] = {0.0f, 0.0f};
  uint32_t p[NT][2];  // bf16 weights: the A fragments of P.V
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = sacc[j][e] == -INFINITY ? 0.0f : __expf(sacc[j][e] - mx[e >> 1]);
      sum[e >> 1] += w[e];
    }
    p[j][0] = pack_bf16(w[0], w[1]);
    p[j][1] = pack_bf16(w[2], w[3]);
  }
  float rinv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    rinv[i] = sum[i] > 0.0f ? 1.0f / sum[i] : 0.0f;
  }

  // out = (P.V) * rinv, one 8-channel n-tile of the head at a time
  const int vcol = 2 * C + h * D;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  for (int dt = 0; dt < D / 8; ++dt) {
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint32_t vaddr = base + (vcol + dt * 8) * 2;
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t b[2];
      ldsm_x2_trans(b, vaddr + min(j * 8 + (lane & 15), last) * pitch);
      const uint32_t a[4] = {p[j][0], p[j][1], p[j + 1][0], p[j + 1][1]};
      mma_16816(o, a, b[0], b[1]);
    }
    if (NT & 1) {
      const uint32_t b =
          ldsm_x1_trans(vaddr + min((NT - 1) * 8 + (lane & 7), last) * pitch);
      mma_1688(o, p[NT - 1][0], p[NT - 1][1], b);
    }
    const int col = h * D + dt * 8 + 2 * t;  // the head's own Q columns
    if (r0 < K)
      *reinterpret_cast<uint32_t*>(tile + r0 * pitch + col * 2) =
          pack_bf16(o[0] * rinv[0], o[1] * rinv[0]);
    if (r1 < K)
      *reinterpret_cast<uint32_t*>(tile + r1 * pitch + col * 2) =
          pack_bf16(o[2] * rinv[1], o[3] * rinv[1]);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
set_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ mask,
                     const int* __restrict__ count,
                     __nv_bfloat16* __restrict__ out, int S, int K, int C,
                     int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = C / H;
  const int C3 = 3 * C;
  const int pitch = C3 * 2 + 16;  // bytes per staged row
  const int stage_bytes = K * pitch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int MT = (K + 15) / 16;
  const float scale = 1.0f / sqrtf((float)D);
  const int n_live = min(max(*count, 0), S);

  // sets >= count: zeros, shared out over every block; nothing is read
  {
    uint4* o4 = reinterpret_cast<uint4*>(out);
    const size_t end = (size_t)S * K * C / 8;
    for (size_t i = (size_t)n_live * K * C / 8 + blockIdx.x * THREADS +
                    threadIdx.x;
         i < end; i += (size_t)gridDim.x * THREADS)
      o4[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  const int row_chunks = C3 / 8;  // 16-byte chunks per row
  auto stage_in = [&](int s, int stage) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(qkv + (size_t)s * K * C3);
    const uint32_t dst = smem_u32(smem + stage * stage_bytes);
    for (int i = threadIdx.x; i < K * row_chunks; i += THREADS) {
      const int r = i / row_chunks, c = i - r * row_chunks;
      cp_async16(dst + r * pitch + c * 16, src + (size_t)i * 16);
    }
  };

  int s = blockIdx.x;
  if (s < n_live) stage_in(s, 0);
  cp_async_commit();
  for (int it = 0; s < n_live; s += gridDim.x, ++it) {
    unsigned char* tile = smem + (it & 1) * stage_bytes;
    if (s + gridDim.x < n_live) stage_in(s + gridDim.x, (it + 1) & 1);
    cp_async_commit();

    const float* mrow = mask + (size_t)s * K;
    const uint32_t lo = __ballot_sync(0xffffffffu, lane < K && mrow[lane] >= 0.0f);
    const uint32_t hi =
        __ballot_sync(0xffffffffu, lane + 32 < K && mrow[lane + 32] >= 0.0f);
    const uint64_t live = ((uint64_t)hi << 32) | lo;

    cp_async_wait<1>();  // this set's rows have landed
    __syncthreads();
    for (int w = warp; w < H * MT; w += WARPS)
      attend<NT>(tile, pitch, live, w / MT, w % MT, K, C, D, scale, lane);
    __syncthreads();

    uint4* o4 = reinterpret_cast<uint4*>(out + (size_t)s * K * C);
    const int out_chunks = C / 8;
    for (int i = threadIdx.x; i < K * out_chunks; i += THREADS) {
      const int r = i / out_chunks, c = i - r * out_chunks;
      o4[i] = *reinterpret_cast<const uint4*>(tile + r * pitch + c * 16);
    }
    __syncthreads();  // the stage is free for the copy after next
  }
  cp_async_wait<0>();
}

template <int NT>
int launch(const void* qkv, const void* mask, const void* count, void* out,
           int S, int K, int C, int H, cudaStream_t stream) {
  const int smem = STAGES * K * (6 * C + 16);
  static int configured = 0;  // dynamic shared memory already allowed
  cudaError_t err;
  if (smem > configured) {
    err = cudaFuncSetAttribute(set_attention_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(set_attention_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, set_attention_kernel<NT>, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = std::min(S, sms * std::max(per_sm, 1));
  set_attention_kernel<NT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(mask),
      static_cast<const int*>(count), static_cast<__nv_bfloat16*>(out), S, K,
      C, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsvt_set_attention(const void* qkv, const void* mask,
                                  const void* count, void* out, int S, int K,
                                  int C, int H, void* stream) {
  if (S < 1 || K < 1 || K > MAX_K || H < 1 || C % H || (C / H) % 8 ||
      (size_t)STAGES * K * (6 * C + 16) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((K + 7) / 8) {
    case 1: return launch<1>(qkv, mask, count, out, S, K, C, H, st);
    case 2: return launch<2>(qkv, mask, count, out, S, K, C, H, st);
    case 3: return launch<3>(qkv, mask, count, out, S, K, C, H, st);
    case 4: return launch<4>(qkv, mask, count, out, S, K, C, H, st);
    case 5: return launch<5>(qkv, mask, count, out, S, K, C, H, st);
    case 6: return launch<6>(qkv, mask, count, out, S, K, C, H, st);
    case 7: return launch<7>(qkv, mask, count, out, S, K, C, H, st);
    default: return launch<8>(qkv, mask, count, out, S, K, C, H, st);
  }
}
