// Kernel B3: segmented max over a cell-sorted point stream.
//
// Replaces: dsvt_ai_trt_tpu/ops/segment_pallas.py:segmented_max (Pallas body
// _seg_kernel), which tiles the stream into row blocks with a halo block on
// each side and runs a segmented Hillis-Steele scan in both directions.
//
// Contract: feats [N, C] (bf16 or f32), is_start [N] (uint8, 1 at each
// segment's first row).  Segments are contiguous and at most `cap` rows.
// Each row gets its whole segment's channelwise max; with starts_only only
// segment-start rows are defined.  Rows of an over-cap segment are
// undefined.  Output has the input's type; math is f32 (max is exact, so
// the result equals the plain version bit for bit on the defined rows).
//
// What bounds it on the H100: bytes.  One read and one write of the stream
// (at C=96 bf16, N=30000: 11.5 MB; at C=192: 23 MB), a few microseconds at
// 3.35 TB/s; the arithmetic is one max per element.
//
// Design: one thread per (column, chunk of ROWS rows).  A warp covers 32
// neighbouring columns of the same chunk, so every row load and store is
// coalesced across the warp, and the is_start byte of a row is a broadcast.
// The thread walks back from its chunk to the segment start (at most cap-1
// rows of halo), runs a forward segmented max through the chunk into the
// output, then walks forward to the segment end (again at most cap-1 rows)
// and runs the backward segmented max, combining the two.  No state crosses
// blocks, which is what the TPU kernel's halo blocks achieved; the halo is
// read from L1/L2, and real segments are a few rows long.  starts_only runs
// the backward pass alone (its value at a start row is the whole segment).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;      // rows per thread chunk
constexpr int COLS = 32;      // columns per block (one warp wide)
constexpr int CHUNKS = 8;     // chunks per block (blockDim.y)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // exact: v is one of the bf16 inputs
}

template <typename T>
__global__ void segment_max_kernel(const T* __restrict__ x,
                                   const uint8_t* __restrict__ start,
                                   T* __restrict__ out, int n, int c,
                                   int starts_only, int cap) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int r0 = (blockIdx.y * CHUNKS + threadIdx.y) * ROWS;
  if (col >= c || r0 >= n) return;
  const int r1 = min(r0 + ROWS, n);
  const T* xc = x + col;
  T* oc = out + col;

  if (!starts_only) {
    // forward: m[r] = max over [start(r), r]
    int s = r0;
    const int lo = max(r0 - (cap - 1), 0);
    while (s > lo && !start[s]) --s;
    float m = -INFINITY;
    for (int r = s; r < r0; ++r) {
      const float v = load(xc + (size_t)r * c);
      m = start[r] ? v : fmaxf(m, v);
    }
    for (int r = r0; r < r1; ++r) {
      const float v = load(xc + (size_t)r * c);
      m = start[r] ? v : fmaxf(m, v);
      store(oc + (size_t)r * c, m);
    }
  }

  // backward: m[r] = max over [r, end(r)]; a row is a segment end when the
  // next row starts a segment or it is the stream's last row
  int e = r1;  // first row after the chunk still inside the last segment
  const int hi = min(r1 + (cap - 1), n);
  while (e < hi && !start[e]) ++e;
  float m = -INFINITY;
  for (int r = e - 1; r >= r1; --r) {
    const float v = load(xc + (size_t)r * c);
    const bool end = (r == n - 1) || start[r + 1];
    m = end ? v : fmaxf(m, v);
  }
  for (int r = r1 - 1; r >= r0; --r) {
    const float v = load(xc + (size_t)r * c);
    const bool end = (r == n - 1) || start[r + 1];
    m = end ? v : fmaxf(m, v);
    if (starts_only) {
      store(oc + (size_t)r * c, m);
    } else {
      const float f = load(oc + (size_t)r * c);  // forward value, own write
      store(oc + (size_t)r * c, fmaxf(f, m));
    }
  }
}

}  // namespace

extern "C" int dsvt_segment_max(const void* feats, const void* is_start,
                                void* out, int n, int c, int is_bf16,
                                int starts_only, int cap, void* stream) {
  const dim3 block(COLS, CHUNKS);
  const int chunks = (n + ROWS - 1) / ROWS;
  const dim3 grid((c + COLS - 1) / COLS, (chunks + CHUNKS - 1) / CHUNKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* flags = static_cast<const uint8_t*>(is_start);
  if (is_bf16) {
    segment_max_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), flags,
        static_cast<__nv_bfloat16*>(out), n, c, starts_only, cap);
  } else {
    segment_max_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(feats), flags, static_cast<float*>(out), n,
        c, starts_only, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
