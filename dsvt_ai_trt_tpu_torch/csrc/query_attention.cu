// Kernel query_attention: the cross-attention of TransFusion-L's decoder
// (upstream DSVT's nuScenes head), a few hundred object queries against
// every cell of the BEV map, with the key and value projections inside.
//
// Replaces no TPU kernel: the JAX package has no TransFusion head.  The
// query projection before it and the out-projection, residual and
// LayerNorm after it stay cuBLAS GEMMs and PyTorch ops on the 200 rows
// (model/transfusion.py).
//
// Contract: q [Nq, 128] bf16 (the queries through the query projection,
// bias included), feats [HW, 128] bf16 (the map L, one row a cell: the
// NHWC layout of the shared conv's output), pos [HW, 128] bf16 (the key
// position embedding Pk of every cell, a constant table), w_kv [256, 128]
// bf16 (the key then the value projection, nn.Linear's [out, in] layout),
// b_kv [256] f32 -> out [Nq, 128] bf16.  x = feats + pos, rounded to bf16
// once; k | v = x w_kv^T + b_kv in f32, rounded to bf16; head h on
// channels [16h, 16h + 16) (8 heads of 16), scale 1/4, softmax over all HW
// keys in f32 (the max subtracted, exp2 of logits in log2 units), the
// unnormalised weights rounded to bf16 for the value product, the row sums
// in f32; the output scaled by 1/sum and rounded once to bf16.  Nq <= 208.
// part [G, NQ, 128 + 16] f32 (NQ = Nq rounded up to 16) is scratch.
//
// What bounds it on the H100: operations.  At the nuScenes cell's shapes
// (Nq = 200, HW = 468 x 468 = 219 024) the projections are 14.4 GFLOP and
// Q.K^T and P.V 22.4 GFLOP, 37 us at 989 TFLOP/s, against 112 MB of L and
// Pk read once, 33 us at 3.35 TB/s.  Under both lies the softmax's
// exponentials: 200 x 8 x 219 024 = 350 M, 16 a clock on each SM's
// special-function units, about 90 us at 1.8 GHz, since a head of 16
// channels gives each exponential only 64 tensor-core operations.
//
// Design: split over the keys.  G = min(SMs, tiles) persistent blocks of
// 8 warps, one a head, 212 KB of shared memory: the queries (zero rows to
// a multiple of 16) and both weight matrices, loaded once, and a ring of
// two stages of 64-key tiles of L and Pk, filled by 16-byte cp.async
// while the tile before computes, rows swizzled (16-byte chunk XOR row %
// 8) so that every ldmatrix is free of bank conflicts.  For each tile a
// warp adds L and Pk as it loads its A fragments (bf16 HADD2), projects
// its own head's 16 key and 16 value channels on mma.sync m16n8k16 (the K
// and V tables never leave the SM), parks them in 4 KB of its own, then
// runs FlashAttention-2's online softmax for every 16-query block of its
// head against the 64 keys: Q.K^T into registers, the running max, the
// rescale, the weights as bf16 A fragments of P.V (ldmatrix.trans for V).
// The 13 query blocks' accumulators, maxima and sums stay in registers
// across all of a block's tiles.  At the end each block writes its
// unnormalised partial output, maxima and sums; a second kernel
// (query_attention_combine_kernel) weighs the G partials by exp2(m - max)
// (FlashDecoding's split-K combine) and writes the bf16 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int C = 128;            // channels of the queries and of L
constexpr int H = 8;              // heads
constexpr int D = C / H;          // 16 channels a head
constexpr int TK = 64;            // keys a tile
constexpr int THREADS = 32 * H;   // one warp a head
constexpr int MAX_QB = 13;        // query blocks of 16: Nq <= 208
constexpr int ROW = C * 2;        // bytes of a bf16 row of 128 channels
constexpr int Q_BYTES = MAX_QB * 16 * ROW;
constexpr int W_BYTES = 2 * C * ROW;
constexpr int TILE_BYTES = TK * ROW;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // L and Pk
constexpr int HEAD_BYTES = 2 * TK * D * 2;    // a warp's K_h and V_h
constexpr int SMEM = Q_BYTES + W_BYTES + 2 * STAGE_BYTES + H * HEAD_BYTES;
constexpr float SCALE_LOG2 = 0.25f * 1.4426950408889634f;  // log2(e)/sqrt(D)
constexpr int COMBINE_THREADS = 256;

// byte offset of 16-byte chunk c of row r in a tile of 256-byte rows
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW + ((c ^ (r & 7)) << 4);
}

// the same in a warp's K_h / V_h tile of 32-byte rows
__device__ __forceinline__ uint32_t swz_head(int r, int c) {
  return r * (D * 2) + ((c ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 s = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&s);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS, 1)
query_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ feats,
                       const __nv_bfloat16* __restrict__ pos,
                       const __nv_bfloat16* __restrict__ w_kv,
                       const float* __restrict__ b_kv,
                       float* __restrict__ part_o, float* __restrict__ part_m,
                       float* __restrict__ part_l, int Nq, int HW) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sq = smem;
  unsigned char* sw = sq + Q_BYTES;
  unsigned char* stages = sw + W_BYTES;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* kt = stages + 2 * STAGE_BYTES + h * HEAD_BYTES;
  unsigned char* vt = kt + TK * D * 2;
  const uint32_t qbase = smem_u32(sq), wbase = smem_u32(sw);
  const uint32_t kbase = smem_u32(kt), vbase = smem_u32(vt);
  const int nqb = (Nq + 15) >> 4, NQ = nqb * 16;
  const int tiles = (HW + TK - 1) / TK;

  for (int i = threadIdx.x; i < NQ * 16; i += THREADS) {
    const int r = i >> 4, c = i & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < Nq) v = reinterpret_cast<const uint4*>(q)[i];
    *reinterpret_cast<uint4*>(sq + swz(r, c)) = v;
  }
  for (int i = threadIdx.x; i < 2 * C * 16; i += THREADS)
    *reinterpret_cast<uint4*>(sw + swz(i >> 4, i & 15)) =
        reinterpret_cast<const uint4*>(w_kv)[i];

  auto stage_in = [&](int tile, int s) {
    const uint32_t lb = smem_u32(stages + s * STAGE_BYTES);
    const size_t row0 = (size_t)tile * TK;
    for (int i = threadIdx.x; i < TK * 16; i += THREADS) {
      const int r = i >> 4, c = i & 15;
      const bool ok = row0 + r < (size_t)HW;
      const size_t at = ok ? (row0 + r) * C + c * 8 : 0;
      cp_async16(lb + swz(r, c), feats + at, ok);
      cp_async16(lb + TILE_BYTES + swz(r, c), pos + at, ok);
    }
  };

  // the warp's output channels: K_h then V_h, two n-tiles of 8 each
  float bias[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = (j < 2 ? 0 : C) + h * D + (j & 1) * 8 + 2 * t;
    bias[j][0] = b_kv[n];
    bias[j][1] = b_kv[n + 1];
  }

  float o[MAX_QB][2][4];   // query block, 8-channel n-tile of the head
  float m[MAX_QB][2];      // running max of rows g, g + 8 (log2 units)
  float l[MAX_QB][2];      // this thread's share of their sums
#pragma unroll
  for (int b = 0; b < MAX_QB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[b][i] = -INFINITY;
      l[b][i] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[b][i][e] = 0.0f;
    }

  int tile = blockIdx.x;
  if (tile < tiles) stage_in(tile, 0);
  cp_async_commit();
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    if (tile + (int)gridDim.x < tiles) stage_in(tile + gridDim.x, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();
    const uint32_t lb = smem_u32(stages + s * STAGE_BYTES);
    const uint32_t pb = lb + TILE_BYTES;

    // k | v of the head's channels for the 64 keys: x = L + Pk in the A
    // fragments, W's rows (output channels) as the B fragments
#pragma unroll 1
    for (int rb = 0; rb < TK / 16; ++rb) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const int ar = rb * 16 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t a[4], ap[4];
        ldsm_x4(a, lb + swz(ar, 2 * ks + (lane >> 4)));
        ldsm_x4(ap, pb + swz(ar, 2 * ks + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = add_bf16x2(a[i], ap[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n0 = (j < 2 ? 0 : C) + h * D + (j & 1) * 8;
          uint32_t b[2];
          ldsm_x2(b, wbase + swz(n0 + (lane & 7), 2 * ks + ((lane >> 3) & 1)));
          mma_16816(acc[j], a, b[0], b[1]);
        }
      }
      __syncwarp();
      const int r0 = rb * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned char* dst = j < 2 ? kt : vt;
        *reinterpret_cast<uint32_t*>(dst + swz_head(r0, j & 1) + 4 * t) =
            pack_bf16(acc[j][0] + bias[j][0], acc[j][1] + bias[j][1]);
        *reinterpret_cast<uint32_t*>(dst + swz_head(r0 + 8, j & 1) + 4 * t) =
            pack_bf16(acc[j][2] + bias[j][0], acc[j][3] + bias[j][1]);
      }
    }
    __syncwarp();

    const int valid = HW - tile * TK;   // keys of this tile (< TK: ragged)
#pragma unroll
    for (int qb = 0; qb < MAX_QB; ++qb) {
      if (qb < nqb) {
        uint32_t a[4];
        ldsm_x4(a, qbase + swz(qb * 16 + (lane & 15), 2 * h + (lane >> 4)));
        float sacc[8][4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t b[4];   // keys 8j.. and 8(j+1).., channels 0-7 | 8-15
          ldsm_x4(b, kbase + swz_head(j * 8 + (lane & 7) + ((lane >> 4) << 3),
                                      (lane >> 3) & 1));
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] = sacc[j + 1][e] = 0.0f;
          mma_16816(sacc[j], a, b[0], b[1]);
          mma_16816(sacc[j + 1], a, b[2], b[3]);
        }
        if (valid < TK) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * 8 + 2 * t + (e & 1) >= valid) sacc[j][e] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sacc[j][0], sacc[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sacc[j][2], sacc[j][3]));
        }
        float mn[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          mn[i] = fmaxf(m[qb][i], mx[i] * SCALE_LOG2);
          const float alpha = ex2(m[qb][i] - mn[i]);
          m[qb][i] = mn[i];
          l[qb][i] *= alpha;
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            o[qb][d][2 * i] *= alpha;
            o[qb][d][2 * i + 1] *= alpha;
          }
        }
        uint32_t p[8][2];   // bf16 weights: the A fragments of P.V
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            w[e] = ex2(fmaf(sacc[j][e], SCALE_LOG2, -mn[e >> 1]));
            l[qb][e >> 1] += w[e];
          }
          p[j][0] = pack_bf16(w[0], w[1]);
          p[j][1] = pack_bf16(w[2], w[3]);
        }
#pragma unroll
        for (int ks = 0; ks < TK / 16; ++ks) {
          uint32_t vb[4];   // keys 16ks.., channels 0-7 (0, 1) | 8-15 (2, 3)
          ldsm_x4_trans(vb, vbase + swz_head(ks * 16 + (lane & 15), lane >> 4));
          const uint32_t pa[4] = {p[2 * ks][0], p[2 * ks][1], p[2 * ks + 1][0],
                                  p[2 * ks + 1][1]};
          mma_16816(o[qb][0], pa, vb[0], vb[1]);
          mma_16816(o[qb][1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // the stage is free for the copy after next
  }
  cp_async_wait<0>();

  float* po = part_o + (size_t)blockIdx.x * NQ * C;
  float* pm = part_m + (size_t)blockIdx.x * NQ * H;
  float* pl = part_l + (size_t)blockIdx.x * NQ * H;
#pragma unroll
  for (int qb = 0; qb < MAX_QB; ++qb) {
    if (qb < nqb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sum = l[qb][i];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = qb * 16 + g + 8 * i;
#pragma unroll
        for (int d = 0; d < 2; ++d)
          *reinterpret_cast<float2*>(po + (size_t)r * C + h * D + d * 8 + 2 * t) =
              make_float2(o[qb][d][2 * i], o[qb][d][2 * i + 1]);
        if (t == 0) {
          pm[r * H + h] = m[qb][i];
          pl[r * H + h] = sum;
        }
      }
    }
  }
}

// out[r, c] = sum_b 2^(m_b - M) o_b[r, c] / sum_b 2^(m_b - M) l_b, over the
// G blocks' partials of row r and c's head
__global__ void __launch_bounds__(COMBINE_THREADS)
query_attention_combine_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               __nv_bfloat16* __restrict__ out, int Nq, int NQ,
                               int G) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= Nq * C) return;
  const int r = i / C, c = i - r * C, h = c / D;
  float mx = -INFINITY;
  for (int b = 0; b < G; ++b) mx = fmaxf(mx, part_m[((size_t)b * NQ + r) * H + h]);
  float num = 0.0f, den = 0.0f;
  for (int b = 0; b < G; ++b) {
    const size_t at = (size_t)b * NQ + r;
    const float w = ex2(part_m[at * H + h] - mx);
    den += w * part_l[at * H + h];
    num += w * part_o[at * C + c];
  }
  out[i] = __float2bfloat16_rn(num / den);
}

}  // namespace

extern "C" int dsvt_query_attention(const void* q, const void* feats,
                                    const void* pos, const void* w_kv,
                                    const void* b_kv, void* part, void* out,
                                    int Nq, int HW, int G, void* stream) {
  const int tiles = (HW + TK - 1) / TK;
  if (Nq < 1 || Nq > MAX_QB * 16 || HW < 1 || G < 1 || G > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // dynamic shared memory already allowed
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(query_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NQ = (Nq + 15) / 16 * 16;
  float* po = static_cast<float*>(part);
  float* pm = po + (size_t)G * NQ * C;
  float* pl = pm + (size_t)G * NQ * H;
  query_attention_kernel<<<G, THREADS, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const __nv_bfloat16*>(pos),
      static_cast<const __nv_bfloat16*>(w_kv), static_cast<const float*>(b_kv),
      po, pm, pl, Nq, HW);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Nq * C + COMBINE_THREADS - 1) / COMBINE_THREADS;
  query_attention_combine_kernel<<<blocks, COMBINE_THREADS, 0, st>>>(
      po, pm, pl, static_cast<__nv_bfloat16*>(out), Nq, NQ, G);
  return static_cast<int>(cudaGetLastError());
}
