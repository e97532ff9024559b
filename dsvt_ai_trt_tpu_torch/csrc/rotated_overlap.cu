// Kernel B4: pairwise intersection area of rotated BEV rectangles.
//
// Replaces: dsvt_ai_trt_tpu/ops/nms_pallas.py:pairwise_overlap_pallas (Pallas
// bodies _overlap_kernel and _overlap_tile).
//
// Contract: corners [N, 8] f32 (x of the four corners, then y, in
// ops/nms.py:box_corners order) -> out [N, N] f32 with the exact
// intersection area of boxes a and b at a < b (the strict upper triangle,
// all that greedy NMS reads) and 0 at a >= b.
//
// What bounds it on the H100: launch and latency.  At N = top_k = 500 it
// writes 1 MB and does a few hundred flops for each of the 125 K upper
// pairs -- well under a microsecond of either bytes or operations.
//
// Design: one thread per (a, b) pair; a warp spans 32 neighbouring b, so
// the output row is written coalesced.  Box a is clipped by the four edges
// of box b (Sutherland-Hodgman) on a compacted vertex list, which emits the
// same vertices in the same order as the TPU kernel's 64-slot validity-
// masked buffer: each live vertex emits itself when inside and the edge
// intersection when its edge crosses.  The buffer keeps 64 slots, the TPU
// kernel's bound, so no input can overflow it.  Then a shoelace sum over
// the polygon in traversal order; fewer than 3 vertices give 0.  Every
// product, sum and quotient is rounded on its own (__fmul_rn and friends:
// nothing is contracted into a fused multiply-add), as PyTorch's separate
// elementwise ops round the plain version's, so both take the same inside
// tests and sum the same terms in the same order.  With contraction the two
// differed by up to ~1e-4 m^2 at 50-60 m coordinates, where one ulp of a
// shoelace term x*y is 2.4e-4.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXV = 64;

// ex * dy - ey * dx, each product rounded before the difference
__device__ __forceinline__ float cross(float ex, float ey, float dx,
                                       float dy) {
  return __fsub_rn(__fmul_rn(ex, dy), __fmul_rn(ey, dx));
}

__device__ float clip_area(const float* ca, const float* cb) {
  float px[MAXV], py[MAXV], qx[MAXV], qy[MAXV];
  int n = 4;
  for (int i = 0; i < 4; ++i) {
    px[i] = ca[i];
    py[i] = ca[4 + i];
  }
  for (int e = 0; e < 4; ++e) {
    const float ax = cb[e], ay = cb[4 + e];
    const float ex = cb[(e + 1) % 4] - ax, ey = cb[4 + (e + 1) % 4] - ay;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const int j = (i + 1 == n) ? 0 : i + 1;
      const float d_cur = cross(ex, ey, px[i] - ax, py[i] - ay);
      const float d_nxt = cross(ex, ey, px[j] - ax, py[j] - ay);
      const bool inside = d_cur >= 0.0f;
      if (inside && m < MAXV) {
        qx[m] = px[i];
        qy[m] = py[i];
        ++m;
      }
      if (inside != (d_nxt >= 0.0f) && m < MAXV) {
        const float t = __fdiv_rn(d_cur, d_cur - d_nxt);
        qx[m] = __fadd_rn(px[i], __fmul_rn(t, px[j] - px[i]));
        qy[m] = __fadd_rn(py[i], __fmul_rn(t, py[j] - py[i]));
        ++m;
      }
    }
    n = m;
    for (int i = 0; i < n; ++i) {
      px[i] = qx[i];
      py[i] = qy[i];
    }
  }
  if (n < 3) return 0.0f;
  float area = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1 == n) ? 0 : i + 1;
    area = __fadd_rn(area, __fsub_rn(__fmul_rn(px[i], py[j]),
                                     __fmul_rn(px[j], py[i])));
  }
  return fabsf(area) * 0.5f;
}

__global__ void rotated_overlap_kernel(const float* __restrict__ corners,
                                       float* __restrict__ out, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y * blockDim.y + threadIdx.y;
  if (a >= n || b >= n) return;
  float v = 0.0f;
  if (a < b) v = clip_area(corners + (size_t)a * 8, corners + (size_t)b * 8);
  out[(size_t)a * n + b] = v;
}

}  // namespace

extern "C" int dsvt_rotated_overlap(const void* corners, void* out, int n,
                                    void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (n + 7) / 8);
  rotated_overlap_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
