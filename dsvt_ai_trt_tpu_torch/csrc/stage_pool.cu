// Kernel stage_pool: the attention pooling between two stages of a staged
// sparse backbone (upstream DSVT-V's Stage_ReductionAtt_Block), one query
// a parent voxel against the keys and values of its at most V children.
//
// Replaces no TPU kernel: the JAX package has no staged backbone.  The
// in-projections (q from the parent's max, k | v from the children rows)
// and the out-projection, residual and LayerNorm stay cuBLAS GEMMs and
// PyTorch ops around it (model/backbone3d.py:pool_forward).
//
// Contract: q [N1, C] bf16 (the query's projection, bias included), kv
// [N0, 2C] bf16 (the children rows' k | v projections, no bias), child
// [N1, V] int64 (the child row of each (parent, slot); N0 or more: the
// slot is empty), kbias [V, C] f32 (slot v's key bias: pos_embedding[v]
// through the key projection, plus its bias), vbias [C] f32, count [1]
// int32 -> out [N1, C] bf16.  Slot v of parent p: key kv[c, :C] +
// kbias[v], value kv[c, C:] + vbias; an empty slot is a zero row through
// the projections (upstream masks no slot), key kbias[v] and value vbias.
// Head h on channels [h*D, (h+1)*D), scale 1/sqrt(D), f32 softmax over
// the slots with the max subtracted, the weighted values summed in f32
// and scaled by 1/sum, rounded once to bf16.  Every parent >= count
// writes zeros.  V <= 8, D a multiple of 8 and at most 64, C a multiple
// of 8.
//
// What bounds it on the H100: bytes.  A parent reads its query row and
// its children's k | v rows and writes one row: at the voxel Waymo
// model's first pooling (about 31 800 children, 21 800 parents, C = 192)
// 24.4 MB of children rows and 16.7 MB of query and output rows, 12 us at
// 3.35 TB/s; the math, 4*V*C operations a parent, is nothing.
//
// Design: one thread a (parent, head), a block of 256 threads covers 32
// parents; the 8 threads of a parent read its query row and each child's
// rows as 16-byte vectors, consecutive heads consecutive vectors, so a
// warp reads whole rows.  The query, the V logits and the D-channel
// accumulator stay in registers; no shared memory, no synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_V = 8;

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// NC: 16-byte vectors (8 channels) a head
template <int NC>
__global__ void __launch_bounds__(THREADS)
stage_pool_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kv,
                  const long long* __restrict__ child,
                  const float* __restrict__ kbias,
                  const float* __restrict__ vbias,
                  const int* __restrict__ count,
                  __nv_bfloat16* __restrict__ out, int N1, int N0, int V,
                  int C, int H) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= N1 * H) return;
  const int p = t / H, h = t - p * H;
  const int col = h * 8 * NC;
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)p * C + col);
  if (p >= min(max(*count, 0), N1)) {
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  float qf[8 * NC];
  const uint4* q4 = reinterpret_cast<const uint4*>(q + (size_t)p * C + col);
#pragma unroll
  for (int c = 0; c < NC; ++c) unpack8(q4[c], qf + 8 * c);
  const float scale = 1.0f / sqrtf((float)(8 * NC));

  long long rows[MAX_V];
  float logit[MAX_V];
  float mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < MAX_V; ++v) {
    rows[v] = -1;
    logit[v] = -INFINITY;
    if (v >= V) continue;
    const long long r = child[(size_t)p * V + v];
    const bool has = r >= 0 && r < N0;
    rows[v] = has ? r : -1;
    const float* kb = kbias + (size_t)v * C + col;
    const uint4* k4 = reinterpret_cast<const uint4*>(kv + (size_t)r * 2 * C + col);
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float kf[8];
      if (has) {
        unpack8(k4[c], kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += qf[8 * c + i] * (kf[i] + kb[8 * c + i]);
    }
    logit[v] = dot * scale;
    mx = fmaxf(mx, logit[v]);
  }

  float acc[8 * NC];
#pragma unroll
  for (int i = 0; i < 8 * NC; ++i) acc[i] = 0.0f;
  float sum = 0.0f;
  const float* vb = vbias + col;
#pragma unroll
  for (int v = 0; v < MAX_V; ++v) {
    if (v >= V) continue;
    const float w = __expf(logit[v] - mx);
    sum += w;
    const long long r = rows[v];
    const uint4* v4 =
        reinterpret_cast<const uint4*>(kv + (size_t)(r < 0 ? 0 : r) * 2 * C + C + col);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float vf[8];
      if (r >= 0) {
        unpack8(v4[c], vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vf[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[8 * c + i] += w * (vf[i] + vb[8 * c + i]);
    }
  }
  const float rinv = 1.0f / sum;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = acc[8 * c + i] * rinv;
    o[c] = pack8(f);
  }
}

template <int NC>
int launch(const void* q, const void* kv, const void* child, const void* kbias,
           const void* vbias, const void* count, void* out, int N1, int N0,
           int V, int C, int H, cudaStream_t stream) {
  const long long threads = (long long)N1 * H;
  const int grid = (int)((threads + THREADS - 1) / THREADS);
  stage_pool_kernel<NC><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
      static_cast<const long long*>(child), static_cast<const float*>(kbias),
      static_cast<const float*>(vbias), static_cast<const int*>(count),
      static_cast<__nv_bfloat16*>(out), N1, N0, V, C, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsvt_stage_pool(const void* q, const void* kv, const void* child,
                               const void* kbias, const void* vbias,
                               const void* count, void* out, int N1, int N0,
                               int V, int C, int H, void* stream) {
  if (N1 < 1 || N0 < 1 || V < 1 || V > MAX_V || H < 1 || C % H ||
      (C / H) % 8 || C / H > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / H / 8) {
    case 1: return launch<1>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 2: return launch<2>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 3: return launch<3>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 4: return launch<4>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 5: return launch<5>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 6: return launch<6>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    case 7: return launch<7>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
    default: return launch<8>(q, kv, child, kbias, vbias, count, out, N1, N0, V, C, H, st);
  }
}
