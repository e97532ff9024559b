// Kernel nms_peel: the greedy NMS's peeling rounds, run to convergence on
// the device.
//
// Replaces: the lax.while_loop of dsvt_ai_trt_tpu/ops/nms.py:nms (:283-301),
// which XLA keeps on the device.  No Pallas kernel computes it; a stopping
// test that PyTorch ops evaluate needs a host read each round, so the port
// writes the loop as a kernel.
//
// Contract: sup [K, K] bool (uint8), sup[i][j] set iff box i (higher score)
// suppresses box j; count [1] int64, the number of valid boxes (rows past
// it start decided and are never kept); K <= 1024.  Each round promotes
// every undecided box with no undecided suppressor, then drops what the
// promoted boxes suppress; the earliest undecided box always promotes, so
// the loop ends within K rounds.  Output: kept [K] bool and its count
// [1] int64, bit-equal to the plain loop (ops/nms_peel.py), since every
// step is the same boolean algebra.
//
// What bounds it on the H100: neither bytes nor operations.  The contract
// reads the K*K mask bytes once (250 KB at K = 500: 0.075 us at 3.35
// TB/s) and does rounds * 2 * K * K/32 word ANDs; it is one block's chain
// of dependent rounds, each two shared-memory passes and three barriers,
// so latency bounds it.
//
// Design: two launches on the caller's stream.  nms_peel_pack_kernel
// spreads the bit-packing over the card: thread (j, w) reads the 32 bytes
// sup[32w .. 32w+31][j] (a warp reads 32 adjacent columns of one row at a
// time) and writes word w of column j, bit b set iff box 32w+b suppresses
// box j, into the [K, W] scratch (W = ceil(K/32)).  nms_peel_kernel is one
// block of 32*W threads, one per box: it copies the packed columns into
// shared memory with an odd row pitch (thread j's words sit on distinct
// banks), keeps the undecided and promoted sets as W-word bit masks built
// by warp ballots, and tests "blocked" and "suppressed" as W word ANDs of
// its own column against them.  __syncthreads_or on the undecided flags is
// the stopping test; __syncthreads_count gives the kept count.  At K = 500
// the packed mask is 34 KB of shared memory; at K = 1024, 135 KB, which
// needs the opt-in that the first launch sets (before any capture).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;
constexpr int PACK_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void nms_peel_pack_kernel(const uint8_t* __restrict__ sup, int K,
                                     int W, uint32_t* __restrict__ packed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * W) return;
  const int w = t / K, j = t - w * K;  // adjacent threads: adjacent columns
  const int i0 = w * 32;
  const int rows = min(32, K - i0);
  uint32_t bits = 0;
#pragma unroll 32
  for (int b = 0; b < 32; ++b) {
    if (b < rows && sup[(size_t)(i0 + b) * K + j]) bits |= 1u << b;
  }
  packed[(size_t)j * W + w] = bits;
}

__global__ void nms_peel_kernel(const uint32_t* __restrict__ packed, int K,
                                int W, const long long* __restrict__ count,
                                uint8_t* __restrict__ kept_out,
                                long long* __restrict__ kept_count) {
  extern __shared__ uint32_t smem[];
  const int pitch = W | 1;
  uint32_t* col = smem;                        // [K][pitch]
  uint32_t* und = col + (size_t)K * pitch;     // [W] undecided boxes
  uint32_t* prom = und + W;                    // [W] promoted this round
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;

  for (int t = threadIdx.x; t < K * W; t += blockDim.x) {
    const int r = t / W;
    col[r * pitch + (t - r * W)] = packed[t];
  }
  const long long n = *count;
  bool undecided = j < K && j < n;
  bool kept = false;
  uint32_t bits = __ballot_sync(FULL, undecided);
  if (lane == 0) und[warp] = bits;
  const uint32_t* mine = col + (size_t)j * pitch;
  int again = __syncthreads_or(undecided);
  while (again) {
    bool blocked = false;
    if (undecided) {
      for (int w = 0; w < W && !blocked; ++w)
        blocked = (mine[w] & und[w]) != 0;
    }
    const bool promote = undecided && !blocked;
    bits = __ballot_sync(FULL, promote);
    if (lane == 0) prom[warp] = bits;
    __syncthreads();  // prom complete; every read of und is done
    bool suppressed = false;
    if (undecided && !promote) {
      for (int w = 0; w < W && !suppressed; ++w)
        suppressed = (mine[w] & prom[w]) != 0;
    }
    kept = kept || promote;
    undecided = undecided && !promote && !suppressed;
    bits = __ballot_sync(FULL, undecided);
    if (lane == 0) und[warp] = bits;
    again = __syncthreads_or(undecided);  // also orders prom's next write
  }
  if (j < K) kept_out[j] = kept ? 1 : 0;
  const int total = __syncthreads_count(kept);
  if (j == 0) *kept_count = total;
}

size_t nms_peel_smem(int K, int W) {
  return ((size_t)K * (W | 1) + 2 * W) * sizeof(uint32_t);
}

}  // namespace

extern "C" int dsvt_nms_peel(const void* sup, int K, const void* count,
                             void* scratch, void* kept, void* kept_count,
                             void* stream) {
  if (K < 1 || K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (K + 31) / 32;
  const size_t smem = nms_peel_smem(K, W);
  static size_t configured = 48 * 1024;  // allowed without the opt-in
  cudaError_t err;
  if (smem > configured) {
    const size_t most = nms_peel_smem(MAX_K, MAX_K / 32);
    err = cudaFuncSetAttribute(nms_peel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = most;
  }
  const int pack_grid = (K * W + PACK_THREADS - 1) / PACK_THREADS;
  nms_peel_pack_kernel<<<pack_grid, PACK_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(sup), K, W, static_cast<uint32_t*>(scratch));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  nms_peel_kernel<<<1, 32 * W, smem, s>>>(
      static_cast<const uint32_t*>(scratch), K, W,
      static_cast<const long long*>(count), static_cast<uint8_t*>(kept),
      static_cast<long long*>(kept_count));
  return static_cast<int>(cudaGetLastError());
}
