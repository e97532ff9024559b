// Kernel B4: pairwise intersection area of rotated BEV rectangles.
//
// Replaces: dsvt_ai_trt_tpu/ops/nms_pallas.py:pairwise_overlap_pallas (Pallas
// bodies _overlap_kernel and _overlap_tile).
//
// Contract: boxes [N, >=7] f32 rows (x, y, z, dx, dy, dz, heading, ...) with
// row stride `ld` floats -> out [N, N] f32 with the exact intersection area
// of boxes a and b at a < b (the strict upper triangle, all that greedy NMS
// reads) and 0 at a >= b.
//
// What bounds it on the H100: launch and latency.  At N = top_k = 500 it
// reads 18 KB and writes 1 MB, 0.30 us at 3.35 TB/s; the operations that
// a frame's boxes need are fewer (0.13 us): a separating-axis test of 67
// f32 operations for each of the 125 K upper pairs, and a clip of ~300
// only for the tens of pairs that overlap.  One launch's own floor on the
// card is about 1 us; what is left is the latency of clipping one pair:
// four dependent passes.
//
// Design: a block covers 8 a-boxes by 32 b-boxes, one thread per pair; a
// warp spans 32 neighbouring b, so the output row is written coalesced.  A
// block wholly at or below the diagonal writes its zeros (16-byte stores
// where rows allow) and returns before anything else, as the Pallas kernel
// skips those tiles.  Otherwise 40 threads build the block's boxes' frames
// and corners in shared memory, from the boxes themselves, with
// box_corners' own rounding: cosf/sinf without fast math (what
// torch.cos/torch.sin run on the card), and every product, difference and
// sum rounded on its own in the PyTorch expression's order.  Each thread
// then runs a separating-axis test on its pair with a margin of 1e-3 of
// the coordinates' scale: the clip's vertices stay within a few ulps of box
// a and of every half-plane of box b, so a pair separated by more than that
// would clip to no vertex and exactly 0, and it writes 0 at once (nearly
// all pairs on a frame).  The near pairs go to a list in shared memory, and
// 16 lanes clip each one together, lane g holding vertex g: box a clipped
// by the four edges of box b (Sutherland-Hodgman), each pass computing
// every vertex's inside test, edge crossing and intersection at once, a
// vertex's output slot the count of emissions before it (ballots and
// popcounts), the new polygon passing through 16 slots in shared memory.
// It emits the same vertices in the same order as the TPU kernel's 64-slot
// validity-masked buffer: each live vertex emits itself when inside and
// the edge intersection when its edge crosses.  Two convex quadrilaterals
// meet in at most 8 vertices; a pass that would emit a 17th (rounding can
// make the clipped polygon non-convex) reruns the pair from the start, one
// vertex at a time, on 64-slot lists in local memory, the TPU kernel's
// bound, which no input can overflow.  Then a shoelace sum over the polygon
// in traversal order, added up by one lane; fewer than 3 vertices give 0.
// Every product, sum and quotient is rounded on its own (__fmul_rn and
// friends: nothing is contracted into a fused multiply-add), as PyTorch's
// separate elementwise ops round the plain version's, so both take the same
// inside tests and sum the same terms in the same order.  With contraction
// the two differed by up to ~1e-4 m^2 at 50-60 m coordinates, where one ulp
// of a shoelace term x*y is 2.4e-4.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, the dense frame's
// 500 boxes): 0.0033 ms device-only, 9% of the 0.30 us bound, against
// 0.011 ms (2.7%) before this design, whose wrapper also built the corners
// in ~15 PyTorch ops; a launch of a one-element fill takes 0.0010 ms on the
// same card.

#include <cuda_runtime.h>
#include <math.h>

#ifndef B4_SLOTS
#define B4_SLOTS 16  // lanes, and vertex slots, that clip one pair (a test
                     // build sets fewer, to drive the 64-slot rerun)
#endif

namespace {

constexpr int TA = 8;      // a-boxes per block (warps)
constexpr int TB = 32;     // b-boxes per block (lanes)
constexpr int THREADS = TA * TB;
constexpr int G = B4_SLOTS;  // a power of two <= 32
constexpr int MAXV = 64;
constexpr unsigned FULL = 0xffffffffu;
static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "B4_SLOTS");

// ex * dy - ey * dx, each product rounded before the difference
__device__ __forceinline__ float cross(float ex, float ey, float dx,
                                       float dy) {
  return __fsub_rn(__fmul_rn(ex, dy), __fmul_rn(ey, dx));
}

// A box's frame: centre, half extents along its local x and y axes, and
// the local x axis (co, si); local y is (-si, co).
struct Frame {
  float cx, cy, hx, hy, co, si;
};

// Box row i (x, y, z, dx, dy, dz, heading, ...) as box_corners reads it:
// half extent dy / 2 along local x, dx / 2 along local y (/ 2.0 is exact as
// * 0.5), cosf/sinf without fast math, as torch.cos/torch.sin run.
__device__ __forceinline__ Frame load_frame(const float* boxes, int ld,
                                            int i) {
  const float* p = boxes + (size_t)i * ld;
  const float heading = __ldg(p + 6);
  return Frame{__ldg(p), __ldg(p + 1), __ldg(p + 4) * 0.5f,
               __ldg(p + 3) * 0.5f, cosf(heading), sinf(heading)};
}

// True when an axis of either box separates the two by more than 1e-3 of
// the coordinates' scale.  The clip's vertices stay within a few ulps of
// box a and of every half-plane of box b, so no vertex can then survive its
// four passes, and the clip would give exactly 0.  NaN compares false and
// clips.
__device__ __forceinline__ bool separated(const Frame& p, const Frame& q) {
  const float c = fabsf(p.co * q.co + p.si * q.si);  // |cos| between axes
  const float s = fabsf(p.si * q.co - p.co * q.si);  // |sin|
  const float phx = fabsf(p.hx), phy = fabsf(p.hy);
  const float qhx = fabsf(q.hx), qhy = fabsf(q.hy);
  const float dx = q.cx - p.cx, dy = q.cy - p.cy;
  const float margin =
      1e-3f * (1.0f + phx + phy + qhx + qhy +
               fmaxf(fmaxf(fabsf(p.cx), fabsf(p.cy)),
                     fmaxf(fabsf(q.cx), fabsf(q.cy))));
  return fabsf(dx * p.co + dy * p.si) > phx + qhx * c + qhy * s + margin ||
         fabsf(dy * p.co - dx * p.si) > phy + qhx * s + qhy * c + margin ||
         fabsf(dx * q.co + dy * q.si) > qhx + phx * c + phy * s + margin ||
         fabsf(dy * q.co - dx * q.si) > qhy + phx * s + phy * c + margin;
}

// ops/nms_kernel.py:box_corners for one box: x of the four corners, then y
__device__ __forceinline__ void box_corners(const Frame& f, float* c) {
  const float cx = f.cx, cy = f.cy, hx = f.hx, hy = f.hy;
  const float co = f.co, si = f.si;
  const float ox[4] = {-hx, hx, hx, -hx};
  const float oy[4] = {-hy, -hy, hy, hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = __fadd_rn(__fsub_rn(__fmul_rn(ox[k], co), __fmul_rn(oy[k], si)),
                     cx);
    c[4 + k] = __fadd_rn(
        __fadd_rn(__fmul_rn(ox[k], si), __fmul_rn(oy[k], co)), cy);
  }
}

// The rerun of a pair that overflowed G slots: the same passes, one vertex
// at a time, on two 64-slot lists in local memory (the TPU kernel's bound,
// which no input can overflow: a pass at most doubles its input), emitting
// the same vertices in the same order.  Out of line, so that the group clip
// keeps its registers: ca_row is box a's 8 corner values, cb_col box b's at
// stride TB.
__device__ __noinline__ float clip_area_local(const float* ca_row,
                                              const float* cb_col) {
  float cb[8];
  float2 v[2][MAXV];
#pragma unroll
  for (int k = 0; k < 8; ++k) cb[k] = cb_col[k * TB];
  for (int i = 0; i < 4; ++i) v[0][i] = make_float2(ca_row[i], ca_row[4 + i]);
  int n = 4, in = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = cb[e], ay = cb[4 + e];
    const float ex = cb[(e + 1) & 3] - ax, ey = cb[4 + ((e + 1) & 3)] - ay;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const float2 p = v[in][i], q = v[in][i + 1 < n ? i + 1 : 0];
      const float dp = cross(ex, ey, p.x - ax, p.y - ay);
      const float dq = cross(ex, ey, q.x - ax, q.y - ay);
      const bool inside = dp >= 0.0f;
      if (inside) v[in ^ 1][m++] = p;
      if (inside != (dq >= 0.0f)) {
        const float t = __fdiv_rn(dp, dp - dq);
        v[in ^ 1][m++] = make_float2(__fadd_rn(p.x, __fmul_rn(t, q.x - p.x)),
                                     __fadd_rn(p.y, __fmul_rn(t, q.y - p.y)));
      }
    }
    n = m;
    in ^= 1;
  }
  if (n < 3) return 0.0f;
  float s = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float2 p = v[in][i], q = v[in][i + 1 < n ? i + 1 : 0];
    s = __fadd_rn(s, __fsub_rn(__fmul_rn(p.x, q.y), __fmul_rn(q.x, p.y)));
  }
  return fabsf(s) * 0.5f;
}

// Area of box a (corners ca_row) clipped by box b, by the G lanes of one
// group, lane g holding vertex g of the polygon (the group's lanes share
// `n`).  Each pass computes every vertex's inside test, edge crossing and
// intersection at once; a vertex's output slot is the count of the
// emissions before it (two ballots and popcounts), and the new polygon goes
// through the group's G slots of `slots` (the warp's 32, in shared memory).  A pass that would emit more than G
// vertices sets `overflow` and empties the polygon.  Every lane of the warp
// takes part (full-mask shuffles); a lane with no pair passes n = 0.
__device__ __forceinline__ float group_clip(const float* ca_row,
                                            const float* cb_col, int n,
                                            float2* slots, bool& overflow) {
  float cb[8];  // box b's corners (cb_col at stride TB)
#pragma unroll
  for (int k = 0; k < 8; ++k) cb[k] = cb_col[k * TB];
  const int lane = threadIdx.x & 31, g = lane & (G - 1), base = lane - g;
  const unsigned group = (G == 32 ? FULL : (1u << G) - 1u) << base;
  const unsigned below = (1u << lane) - 1u;
  overflow = false;
  float vx = g < 4 ? ca_row[g & 3] : 0.0f;
  float vy = g < 4 ? ca_row[4 + (g & 3)] : 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = cb[e], ay = cb[4 + e];
    const float ex = cb[(e + 1) & 3] - ax, ey = cb[4 + ((e + 1) & 3)] - ay;
    const float d = cross(ex, ey, vx - ax, vy - ay);
    const int next = base + (g + 1 == n ? 0 : (g + 1) & (G - 1));
    const float nx = __shfl_sync(FULL, vx, next);
    const float ny = __shfl_sync(FULL, vy, next);
    const float dn = __shfl_sync(FULL, d, next);
    const bool inside = g < n && d >= 0.0f;
    const bool crossing = g < n && (d >= 0.0f) != (dn >= 0.0f);
    const unsigned in_bits = __ballot_sync(FULL, inside) & group;
    const unsigned cr_bits = __ballot_sync(FULL, crossing) & group;
    const int m = __popc(in_bits) + __popc(cr_bits);
    const int pos = __popc(in_bits & below) + __popc(cr_bits & below);
    if (m > G) overflow = true;
    if (!overflow) {
      if (inside) slots[base + pos] = make_float2(vx, vy);
      if (crossing) {
        const float t = __fdiv_rn(d, d - dn);
        slots[base + pos + inside] =
            make_float2(__fadd_rn(vx, __fmul_rn(t, nx - vx)),
                        __fadd_rn(vy, __fmul_rn(t, ny - vy)));
      }
    }
    __syncwarp();
    n = overflow ? 0 : m;
    if (g < n) {
      const float2 v = slots[lane];
      vx = v.x;
      vy = v.y;
    }
    __syncwarp();
  }
  // shoelace in traversal order: lane 0 of the group sums the terms
  const int next = base + (g + 1 == n ? 0 : (g + 1) & (G - 1));
  const float nx = __shfl_sync(FULL, vx, next);
  const float ny = __shfl_sync(FULL, vy, next);
  const float term = __fsub_rn(__fmul_rn(vx, ny), __fmul_rn(nx, vy));
  float s = 0.0f;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const float th = __shfl_sync(FULL, term, base + h);
    if (h < n) s = __fadd_rn(s, th);
  }
  return n < 3 ? 0.0f : fabsf(s) * 0.5f;
}

__global__ void __launch_bounds__(THREADS)
    rotated_overlap_kernel(const float* __restrict__ boxes, int ld,
                           float* __restrict__ out, int n, int* slow_pairs) {
  __shared__ Frame frame_sm[TB + TA];  // b-boxes, then a-boxes
  __shared__ float ca_sm[TA][8];
  __shared__ float cb_sm[8][TB];
  __shared__ int pairs_sm[THREADS];    // the near pairs' thread indices
  __shared__ float area_sm[THREADS];   // their areas, by thread index
  __shared__ float2 slots_sm[THREADS];  // G vertex slots per lane group
  __shared__ int n_near;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB, a0 = blockIdx.y * TA;
  const int a = a0 + tid / TB, b = b0 + tid % TB;

  if (a0 >= b0 + TB - 1) {  // every a >= every b: zeros only
    if ((n & 3) == 0) {     // rows start on 16 bytes: one float4 a thread
      constexpr int Q = TB / 4;
      const int r = a0 + tid / Q, c = b0 + 4 * (tid % Q);
      if (tid < TA * Q && r < n && c < n)
        *reinterpret_cast<float4*>(out + (size_t)r * n + c) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (a < n && b < n) {
      out[(size_t)a * n + b] = 0.0f;
    }
    return;
  }

  // the first TB + TA threads build the frames and corners of the block's
  // b-boxes, then its a-boxes
  const int box = tid < TB ? b0 + tid : a0 + tid - TB;
  if (tid < TB + TA && box < n) {
    const Frame f = load_frame(boxes, ld, box);
    float c[8];
    box_corners(f, c);
    frame_sm[tid] = f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (tid < TB) {
        cb_sm[k][tid] = c[k];
      } else {
        ca_sm[tid - TB][k] = c[k];
      }
    }
  }
  if (tid == 0) n_near = 0;
  __syncthreads();

  // a pair is near unless an axis separates its boxes; near pairs go to a
  // list, and lane groups clip them
  const bool in_range = a < n && b < n;
  const bool near = in_range && a < b &&
                    !separated(frame_sm[TB + tid / TB], frame_sm[tid % TB]);
  if (near) pairs_sm[atomicAdd(&n_near, 1)] = tid;
  __syncthreads();
  const int count = n_near;
  if (count > 0) {
    constexpr int PER_WARP = 32 / G;
    const int warp = tid / 32, lane = tid & 31;
    for (int k0 = warp * PER_WARP; k0 < count; k0 += THREADS / G) {
      const int k = k0 + lane / G;
      const int p = pairs_sm[k < count ? k : 0];
      bool overflow;
      const float v = group_clip(ca_sm[p / TB], &cb_sm[0][p % TB],
                                 k < count ? 4 : 0, slots_sm + warp * 32,
                                 overflow);
      if (k < count && (lane & (G - 1)) == 0) {
        if (overflow) {
          area_sm[p] = clip_area_local(ca_sm[p / TB], &cb_sm[0][p % TB]);
          if (slow_pairs != nullptr) atomicAdd(slow_pairs, 1);
        } else {
          area_sm[p] = v;
        }
      }
    }
    __syncthreads();
  }
  if (in_range) out[(size_t)a * n + b] = near ? area_sm[tid] : 0.0f;
}

}  // namespace

// slow_pairs: null, or an int on the card that counts the pairs that took
// the 64-slot rerun.
extern "C" int dsvt_rotated_overlap(const void* boxes, int ld, void* out,
                                    int n, void* slow_pairs, void* stream) {
  const dim3 grid((n + TB - 1) / TB, (n + TA - 1) / TA);
  rotated_overlap_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), ld, static_cast<float*>(out), n,
      static_cast<int*>(slow_pairs));
  return static_cast<int>(cudaGetLastError());
}
