// Kernel B3: segmented max over a cell-sorted point stream.
//
// Replaces: dsvt_ai_trt_tpu/ops/segment_pallas.py:segmented_max (Pallas body
// _seg_kernel), which tiles the stream into row blocks with a halo block on
// each side and runs a segmented Hillis-Steele scan in both directions.
//
// Contract: feats [N, C] (bf16 or f32), is_start [N] (bool or uint8, nonzero
// at each segment's first row; row 0 always starts one).  Segments are
// contiguous; 1 <= cap <= 64, the Pallas kernel's own limit.  Each row of a
// segment of at most `cap` rows gets the segment's channelwise max; with
// starts_only only its first row is defined.  Rows of an over-cap segment
// are undefined, and this kernel neither reads nor writes them.  Output has
// the input's type; max is exact, so the result equals the plain version
// bit for bit on the defined rows.
//
// What bounds it on the H100: bytes.  The contract needs one read of the
// defined rows, one write of each defined row (full) or of each segment's
// first row (starts_only), and one read of the flags.  On a dense 20 000-
// point frame (N = 30 000, 10 728 defined rows, 10 000 segments) that is
// 4.15 MB at C = 96 bf16 and 8.0 MB at C = 192: 3.6 us for both calls at
// 3.35 TB/s.  The arithmetic is one max per element read.
//
// Design: a block owns a tile of 32 rows -- one warp's lanes -- and the
// segments that START in it; it reads no row before its tile and at most
// cap - 1 rows past it, so every defined row is read once and written once
// and no state crosses blocks.  The 32 + cap flags become one register
// ballot per warp; every warp then finds, lane by lane, where the segment
// starting at its row ends (the next set bit, __ffs) and whether it is
// defined, and one more ballot gives the defined segments as a bit mask,
// with no atomics.  Then each thread takes (segment, 16-byte vector)
// pairs: it loads the segment's rows at that vector straight from global
// memory (the loads of a segment do not depend on each other, so they are
// in flight together; a warp's loads of one row are contiguous), takes the
// max, and stores it with 16-byte stores to every row of the segment, or to
// its first row alone with starts_only.  Nothing is staged in shared
// memory: on the dense frame's segments of one or two rows a staging copy
// only added a barrier and a shared-memory round trip (staging was not
// measured on long segments).  Rows split into slabs of at most
// 128 bytes along gridDim.y (C = 96 bf16: 2, C = 192: 3), which gives the
// card 1 900-2 800 blocks of 96 threads at N = 30 000.  A row whose bytes
// are no multiple of 16, or a base not on a 16-byte boundary, takes the
// same kernel with one element per unit.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, main-path inputs
// of the dense frame): 0.0031 ms device-only at C = 96 and 0.0036 ms at
// C = 192 starts_only, 0.0067 ms for both against the 0.0036 ms their bytes
// need (54%) and 0.035 ms before this design.  Both calls take about the
// same time for bytes that differ 2x: a block's chain of two dependent
// memory round trips (flags, then rows) and its stores bounds the call,
// not bandwidth.  A scatter_reduce("amax") into the segment table takes
// 0.71 ms on the same inputs.  On a seeded stream of 1..48-row segments
// (25.1 rows on average, as real clouds' pillars hold up to 48 points), at
// the same two shapes: 0.0055-0.0056 ms (61-63% of its 0.0034 ms bound) and
// 0.0058-0.0059 ms (61-62% of 0.0036 ms); a block then has only about 8 busy
// threads, but each
// streams about 25 rows of independent loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 32;  // rows whose segments a block owns: a warp's lanes
                          // (ops/segment.py:TILE, which the tests read,
                          // must match)
constexpr int MAX_CAP = 64;
constexpr int THREADS = TILE + MAX_CAP;  // one flag row each
constexpr int FLAG_WORDS = THREADS / 32;
constexpr int SLAB_BYTES = 128;  // row bytes one block covers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float umax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ __nv_bfloat16 umax(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __hmax(a, b);
}

// max of two 16-byte vectors of T
template <typename T>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same_v<T, float>) {
      pa[i] = __float_as_uint(fmaxf(__uint_as_float(pa[i]),
                                    __uint_as_float(pb[i])));
    } else {
      __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&pa[i]),
                                 *reinterpret_cast<const __nv_bfloat162*>(
                                     &pb[i]));
      pa[i] = *reinterpret_cast<uint32_t*>(&r);
    }
  }
  return a;
}

// first set bit after position r, or `end` when there is none
__device__ __forceinline__ int next_bit(const uint32_t* bits, int r, int end) {
  const int p = r + 1;
  for (int w = p >> 5; w < FLAG_WORDS; ++w) {
    uint32_t m = bits[w];
    if (w == (p >> 5)) m &= ~0u << (p & 31);
    if (m) return w * 32 + __ffs(m) - 1;
  }
  return end;
}

// VEC: a unit is 16 bytes of T; else one T.  `units` is the row length in
// units, `slab` the units one block covers.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    segment_max_kernel(const T* __restrict__ x,
                       const uint8_t* __restrict__ start, T* __restrict__ out,
                       int n, int units, int slab, int starts_only, int cap) {
  using U = std::conditional_t<VEC, uint4, T>;
  __shared__ uint32_t bits[FLAG_WORDS];
  __shared__ int seg_lo[TILE], seg_hi[TILE];  // defined segments, in rows
  //                                             relative to the tile

  const int tid = threadIdx.x, lane = tid & 31;
  const int t0 = blockIdx.x * TILE;
  const int u0 = blockIdx.y * slab;
  const int w = min(slab, units - u0);
  const int flag_rows = min(TILE + cap, n - t0);

  const bool f = tid < flag_rows && (start[t0 + tid] != 0 || t0 + tid == 0);
  const uint32_t ballot = __ballot_sync(FULL, f);
  if (lane == 0) bits[tid >> 5] = ballot;
  __syncthreads();

  // every warp: lane l looks at tile row l.  A segment starting there ends
  // at the next start among the flags read, else at the stream's end, or
  // is longer than cap when the stream goes on past the flags read.
  const bool starts = (bits[0] >> lane) & 1u;  // 0 past the stream's end
  const int end = next_bit(bits, lane, flag_rows);
  const uint32_t defined = __ballot_sync(FULL, starts && end - lane <= cap);
  if (defined == 0) return;  // no defined segment starts in this tile
  const int n_seg = __popc(defined);
  if (tid < 32 && ((defined >> lane) & 1u)) {  // the list, in order
    const int k = __popc(defined & ((1u << lane) - 1u));
    seg_lo[k] = lane;
    seg_hi[k] = end;
  }

  __syncthreads();  // the segment list
  const U* xu = reinterpret_cast<const U*>(x);
  U* ou = reinterpret_cast<U*>(out);

  // (segment, vector) pairs: the max over the segment's rows, loaded
  // straight from global memory (a segment's loads are independent), then
  // stored to every row of the segment, or to its first row alone
  for (int i = tid; i < n_seg * w; i += THREADS) {
    const int k = i / w, u = i - k * w;
    const int s = seg_lo[k], e = seg_hi[k];
    const U* src = xu + (size_t)(t0 + s) * units + u0 + u;
    U m = src[0];
#pragma unroll 4
    for (int r = 1; r < e - s; ++r) {
      if constexpr (VEC) {
        m = vmax<T>(m, src[(size_t)r * units]);
      } else {
        m = umax(m, src[(size_t)r * units]);
      }
    }
    U* dst = ou + (size_t)(t0 + s) * units + u0 + u;
    const int n_out = starts_only ? 1 : e - s;
    for (int r = 0; r < n_out; ++r) dst[(size_t)r * units] = m;
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* feats, const uint8_t* flags, void* out, int n,
                   int c, int starts_only, int cap, cudaStream_t s) {
  const int unit_bytes = VEC ? 16 : (int)sizeof(T);
  const int units = VEC ? c * (int)sizeof(T) / 16 : c;
  const int max_slab = SLAB_BYTES / unit_bytes;
  const int n_slabs = (units + max_slab - 1) / max_slab;
  const int slab = (units + n_slabs - 1) / n_slabs;
  const dim3 grid((n + TILE - 1) / TILE, n_slabs);
  segment_max_kernel<T, VEC><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(feats), flags, static_cast<T*>(out), n, units,
      slab, starts_only, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsvt_segment_max(const void* feats, const void* is_start,
                                void* out, int n, int c, int is_bf16,
                                int starts_only, int cap, void* stream) {
  if (cap < 1 || cap > MAX_CAP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* flags = static_cast<const uint8_t*>(is_start);
  const int elt = is_bf16 ? 2 : 4;
  const bool vec = (c * elt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? launch<__nv_bfloat16, true>(feats, flags, out, n, c,
                                             starts_only, cap, s)
              : launch<__nv_bfloat16, false>(feats, flags, out, n, c,
                                              starts_only, cap, s);
  } else {
    err = vec ? launch<float, true>(feats, flags, out, n, c, starts_only, cap,
                                    s)
              : launch<float, false>(feats, flags, out, n, c, starts_only, cap,
                                     s);
  }
  return static_cast<int>(err);
}
