// Kernel nms_peel: the greedy NMS after the pairwise overlap, in one launch:
// the suppression bits, the peeling rounds run to convergence, and the
// keep-first compaction of the boxes.
//
// Replaces: dsvt_ai_trt_tpu/ops/nms.py:nms after the overlap (:270-301):
// the IoU and its threshold, the lax.while_loop of peeling rounds (which
// XLA keeps on the device) and the stable argsort and gathers that move
// the kept boxes first.  No Pallas kernel computes it; a stopping test that
// PyTorch ops evaluate needs a host read each round, so the port writes it
// as a kernel.
//
// Contract: overlap [K, K] f32 (values below the diagonal are ignored),
// boxes [K, 9] f32 sorted by score, count [1] int64 (rows past it are never
// kept and suppress nothing), threshold f32; K <= 1024.  Box i suppresses
// box j iff i < j, i < count and
//   fl(overlap / max(sa_i + sa_j - overlap, 1e-8)) >= threshold,
// sa = b3 * b4, each operation rounded as PyTorch's ops round it (__fmul_rn
// so that -fmad cannot fuse the area into the add, __fadd_rn then
// __fsub_rn, a clamp that lets NaN through as torch.clamp does), so the
// bits equal the plain version's.  Each round promotes every undecided box
// with no undecided suppressor, then drops what the promoted boxes
// suppress; the earliest undecided box always promotes, so the loop ends
// within K rounds.  Output: boxes_out [K, 9] with the kept boxes first in
// index order, then zero rows, and the kept count [] int64: bit-equal to
// the plain version (ops/nms_peel.py).
//
// What bounds it on the H100: neither bytes nor operations.  It reads the
// upper triangle of overlap once (0.5 MB at K = 500: 0.15 us at 3.35 TB/s)
// and does rounds * 2 * K * K/32 word ANDs; the rounds are one block's
// chain of dependent steps, two barriers each, so latency bounds it, and
// one launch is the floor.
//
// Design: one launch of a thread-block cluster of CL = min(NW, 8) blocks
// (the portable size), 32 * NW threads each (NW = ceil(K/32) rounded up to
// a power of two, a template parameter so that a thread's column lives in
// registers).
//   1. Suppression bits.  Word w of column j holds bit b iff box 32w + b
//      suppresses box j.  The triangle's 32 x 32 tiles (w, c), w <= c, go
//      one to a warp over the cluster's warps.  A lane of the warp owns
//      column 32c + lane: it issues all 32 loads of its column's slice at
//      once (a warp reads 32 adjacent floats of one row; the row and column
//      are clamped into the matrix, so no load waits on a test), the
//      rows' areas come from the lanes by shuffle, and a row slice that is
//      zero across the warp (most of a frame's: 0 / u is never >= a
//      positive threshold) skips the arithmetic.  The threshold test needs
//      no division: fl(thr (1 +- 2^-18) u) brackets ov, and only a quotient
//      within 2^-18 of the threshold (or NaN, or a threshold or union
//      outside [2^-60, 2^60]) takes the IEEE division __fdiv_rn.  The word
//      goes straight into block 0's shared memory through distributed
//      shared memory (cluster.map_shared_rank), word-major ([NW][32 NW]:
//      adjacent lanes, adjacent words), and the cluster barrier publishes
//      them.  No mask or scratch array reaches device memory.
//   2. Rounds, in block 0, one thread a box.  Each thread loads its
//      column's NW words into registers once (words below the diagonal are
//      zero and never written).  The undecided set (double buffered) and
//      the promoted set are NW-word bit masks in shared memory, built by
//      warp ballots, which every thread reads from the same address as
//      16-byte broadcast loads: "blocked" and "suppressed" are NW ANDs with
//      no dependent walk, skipped by a warp with no undecided box.  Two
//      barriers a round; __syncthreads_or on the undecided flags is the
//      stopping test.
//   3. Compaction.  Each thread's box row is loaded during the rounds.
//      Warp ballots of the kept flags and a scan of the per-warp counts
//      give each kept box its slot; the rows are staged in the columns'
//      shared memory and written out in coalesced runs, zeros from the
//      kept count on; __syncthreads_count gives the kept count.
// Shared memory: 4 NW * 32 NW bytes of columns (32 KB at K = 500, 128 KB at
// K = 1024, which needs the opt-in that the first launch sets, before any
// capture).  A cluster launch is captured into a CUDA graph like any
// other launch.
//
// Measured (nms_timing.py, H100 80GB HBM3 at 700 W; PERF.md): 0.0069 ms on
// the dense frame's 500 boxes, against 0.0085 ms for the parent's two
// launches that only ran the rounds on a mask PyTorch built; 0.085 ms on a
// 250-round chain (0.32 before).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_K = 1024;
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int BOX = 9;            // floats a box
constexpr unsigned FULL = 0xffffffffu;
// the quick test's range for the threshold and the union (design, step 1):
// there thr (1 +- 2^-18) u is normal and rounded within 2^-24, so
// ov > fl(thr (1 + 2^-18) u) proves ov / u >= thr (1 + 2^-19), whose
// rounding is >= thr, and ov < fl(thr (1 - 2^-18) u) proves it is < thr
constexpr float QUICK_LO = 0x1p-60f, QUICK_HI = 0x1p60f;

__device__ __forceinline__ float box_area(const float* boxes, int i) {
  return __fmul_rn(boxes[i * BOX + 3], boxes[i * BOX + 4]);
}

__device__ __forceinline__ float union_area(float sa_i, float sa_j,
                                            float ov) {
  const float u = __fsub_rn(__fadd_rn(sa_i, sa_j), ov);
  return u < 1e-8f ? 1e-8f : u;   // torch.clamp(min=1e-8): NaN passes
}

// Box i suppresses box j (given i < j < K and i < count): the plain
// version's IoU, operation by operation.
__device__ __forceinline__ bool suppresses(float sa_i, float sa_j, float ov,
                                           float thr) {
  return __fdiv_rn(ov, union_area(sa_i, sa_j, ov)) >= thr;
}

// any(mine[w] & mask[w]) over the NW words of a shared-memory mask that
// every thread reads at the same address.
template <int NW>
__device__ __forceinline__ bool hits(const uint32_t (&mine)[NW],
                                     const uint32_t* mask) {
  uint32_t acc = 0;
  if constexpr (NW % 4 == 0) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 v = m4[q];
      acc |= (mine[4 * q] & v.x) | (mine[4 * q + 1] & v.y) |
             (mine[4 * q + 2] & v.z) | (mine[4 * q + 3] & v.w);
    }
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) acc |= mine[w] & mask[w];
  }
  return acc != 0;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int NW>
__global__ void __launch_bounds__(32 * NW)
    nms_peel_kernel(const float* __restrict__ overlap,
                    const float* __restrict__ boxes, int K,
                    const long long* __restrict__ count, float thr,
                    float* __restrict__ out,
                    long long* __restrict__ kept_count) {
  constexpr int NT = 32 * NW;                       // threads, boxes padded
  constexpr int CL = NW < MAX_CLUSTER ? NW : MAX_CLUSTER;
  extern __shared__ uint4 smem4[];
  uint32_t* col = reinterpret_cast<uint32_t*>(smem4);  // [NW][NT]
  uint32_t* und = col + (NW > BOX ? NW : BOX) * NT;    // [2][NW]
  uint32_t* prom = und + 2 * NW;                       // [NW]

  // the cluster's blocks have started once this arrive is matched; wait
  // for it only before touching block 0's shared memory
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const long long n = *count;
  const int rows = n < 0 ? 0 : (n < K ? static_cast<int>(n) : K);

  // 1. the words, one tile t = (w, c) a warp: word w of the columns of
  // warp c.  Out of the quick test's range the bounds are NaN: nothing is
  // sure.
  const bool quick = thr >= QUICK_LO && thr <= QUICK_HI;
  const float nan = __int_as_float(0x7fc00000);
  const float hi = quick ? thr * (1.f + 0x1p-18f) : nan;
  const float lo = quick ? thr * (1.f - 0x1p-18f) : nan;
  const int warps = (K + 31) / 32;
  cluster_wait();
  uint32_t* leader = cluster.map_shared_rank(col, 0);
  for (int t = rank * NW + warp; t < warps * (warps + 1) / 2;
       t += CL * NW) {
    int c = 0;
    while ((c + 1) * (c + 2) / 2 <= t) ++c;
    const int w = t - c * (c + 1) / 2;
    const int i0 = 32 * w, jc = 32 * c + lane;
    const float* src = overlap + min(jc, K - 1);
    float ov[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) ov[b] = src[(size_t)min(i0 + b, K - 1) * K];
    // the strict upper triangle: rows i0 <= i < min(jc, i0 + 32)
    const int above = jc < K ? min(i0 + 32, jc) : i0;
#pragma unroll
    for (int b = 0; b < 32; ++b) ov[b] = i0 + b < above ? ov[b] : 0.f;
    const float sa_j = jc < K ? box_area(boxes, jc) : 0.f;
    const float sa_lane = i0 + lane < K ? box_area(boxes, i0 + lane) : 0.f;
    const int top = min(above, rows);               // and below the count
    uint32_t bits = 0, unsure = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (quick && !__any_sync(FULL, ov[b] != 0.f)) continue;
      const float sa_i = __shfl_sync(FULL, sa_lane, b);
      const float u = union_area(sa_i, sa_j, ov[b]);
      const uint32_t in = i0 + b < top;
      const uint32_t yes = ov[b] > __fmul_rn(hi, u);
      const uint32_t sure =
          (u <= QUICK_HI) & (yes | (ov[b] < __fmul_rn(lo, u)));
      bits |= (in & sure & yes) << b;
      unsure |= (in & (sure ^ 1u)) << b;
    }
    while (unsure) {                                // rare: IEEE division
      const int b = __ffs(unsure) - 1;
      unsure &= unsure - 1;
      const int i = i0 + b;
      if (suppresses(box_area(boxes, i), sa_j, overlap[(size_t)i * K + jc],
                     thr))
        bits |= 1u << b;
    }
    leader[w * NT + jc] = bits;
  }
  cluster.sync();                  // block 0 sees every word
  if (rank != 0) return;

  // 2. the rounds; this thread's box row comes in meanwhile
  float row[BOX];
#pragma unroll
  for (int c = 0; c < BOX; ++c) row[c] = j < K ? boxes[j * BOX + c] : 0.f;
  uint32_t mine[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)     // no tile below the diagonal
    mine[w] = w <= warp ? col[w * NT + j] : 0u;
  bool undecided = j < rows;
  bool kept = false;
  int cur = 0;
  uint32_t bits = __ballot_sync(FULL, undecided);
  if (lane == 0) und[warp] = bits;
  int again = __syncthreads_or(undecided);
  while (again) {
    // a warp with no undecided box skips the ANDs
    const bool active = __any_sync(FULL, undecided);
    const bool promote =
        active && undecided && !hits<NW>(mine, und + cur * NW);
    bits = __ballot_sync(FULL, promote);
    if (lane == 0) prom[warp] = bits;
    __syncthreads();               // prom complete
    const bool suppressed =
        active && undecided && !promote && hits<NW>(mine, prom);
    kept = kept || promote;
    undecided = undecided && !promote && !suppressed;
    cur ^= 1;                      // the other buffer: no read of it is due
    bits = __ballot_sync(FULL, undecided);
    if (lane == 0) und[cur * NW + warp] = bits;
    again = __syncthreads_or(undecided);  // also: every read of prom done
  }

  // 3. compaction: kept boxes first, in index order, then zero rows,
  // staged in shared memory (the columns are no longer needed) so that the
  // block writes boxes_out in coalesced runs
  bits = __ballot_sync(FULL, kept);
  if (lane == 0) prom[warp] = __popc(bits);
  const int total = __syncthreads_count(kept);
  const int warp_kept = lane < NW ? static_cast<int>(prom[lane]) : 0;
  int scan = warp_kept;            // inclusive scan over the warps
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan += v;
  }
  const int before = __shfl_sync(FULL, scan - warp_kept, warp);
  float* stage = reinterpret_cast<float*>(col);     // [K][9]
  if (kept) {
    const int slot = before + __popc(bits & ((1u << lane) - 1u));
#pragma unroll
    for (int c = 0; c < BOX; ++c) stage[slot * BOX + c] = row[c];
  }
  __syncthreads();
  for (int t = j; t < K * BOX; t += NT)
    out[t] = t < total * BOX ? stage[t] : 0.f;
  if (j == 0) *kept_count = total;
}

// the columns [NW][32 NW] (later the staged rows [K][9]) and the masks
constexpr size_t smem_bytes(int nw) {
  return ((nw > BOX ? nw : BOX) * 32 * static_cast<size_t>(nw) + 3 * nw) *
         sizeof(uint32_t);
}

template <int NW>
cudaError_t launch(const float* overlap, const float* boxes, int K,
                   const long long* count, float thr, float* out,
                   long long* kept_count, cudaStream_t s) {
  constexpr int CL = NW < MAX_CLUSTER ? NW : MAX_CLUSTER;
  constexpr size_t smem = smem_bytes(NW);
  static bool configured = smem <= 48 * 1024;  // allowed without the opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_peel_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nms_peel_kernel<NW>, overlap, boxes, K,
                            count, thr, out, kept_count);
}

}  // namespace

extern "C" int dsvt_nms_peel(const void* overlap, const void* boxes, int K,
                             const void* count, float thr, void* out,
                             void* kept_count, void* stream) {
  if (K < 1 || K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ov = static_cast<const float*>(overlap);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* n = static_cast<const long long*>(count);
  auto* o = static_cast<float*>(out);
  auto* kc = static_cast<long long*>(kept_count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + 31) / 32;
  cudaError_t err;
  if (words <= 1) err = launch<1>(ov, bx, K, n, thr, o, kc, s);
  else if (words <= 2) err = launch<2>(ov, bx, K, n, thr, o, kc, s);
  else if (words <= 4) err = launch<4>(ov, bx, K, n, thr, o, kc, s);
  else if (words <= 8) err = launch<8>(ov, bx, K, n, thr, o, kc, s);
  else if (words <= 16) err = launch<16>(ov, bx, K, n, thr, o, kc, s);
  else err = launch<32>(ov, bx, K, n, thr, o, kc, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
