// Kernel voxel_segments: the voxelizer's segment work over a cell-sorted
// point stream, in two launches a frame.
//
// Replaces no Pallas kernel: the JAX package's ops/voxelize.py leaves this
// work to XLA's scans (two cummax scans for the ranks within and to the end
// of each pillar, a segmented Hillis-Steele sum and a pointer-jumping
// broadcast, a sort that lists the pillars' head rows), which the plain
// version (ops/voxelize.py) runs as ~100 PyTorch launches, three of them
// torch.cummax scans that walk the whole stream in one block.
//
// Contract (ops/voxelize_kernel.py checks it):
//   phase 0, the cap on the full stream: cell [n] int64, sorted, the
//     sentinel gx * gy * gz marking invalid rows.  Writes key [n]: the cell
//     where the row lies fewer than `cap` rows after its pillar's first row,
//     else the sentinel.  On a sorted stream that is i < cap or
//     cell[i - cap] != cell[i], exactly the plain version's rank < cap.
//   phase 1, the pillars of the compacted stream: cell [rows] int64 (sorted
//     again after the cap, so no pillar is longer than cap <= 64 rows), pid
//     [rows] (each row's pillar, the cumsum of the pillar heads less one),
//     points [*, 4] f32 and the two sorts' orders (row i's point is
//     points[perm[perm2[i]]]).  Writes feats [rows, 10], point_pillar
//     [rows], kept [rows], and the registry: counts [P], coords [P, D]
//     (D = 2, or 3 with gz > 1), pillar_valid [P] and pillar_count [].
//   Every field equals the plain version's bit for bit: each pillar's x, y
//   and z sums are formed by the same Hillis-Steele steps (1, 2, ..., 32,
//   a row adding its value s rows back, or +0, where its rank is >= s) in
//   the same order, the total is the inclusive value at the pillar's last
//   row (which the pointer jumping broadcasts), divided by the same count
//   in IEEE division; the cell centres are formed in float64 as the plain
//   version forms them.  The __f*_rn and __d*_rn intrinsics keep nvcc from
//   contracting or reordering any of it.
//
// What bounds it on the H100: bytes.  Phase 0 reads and writes 8 bytes a
// row; phase 1 reads ~48 bytes a row (cell, pid, the two orders, the
// point) and writes 49 (feats, point_pillar, kept) plus ~33 a pillar: at
// the Waymo caps (200 000 and 140 000 rows, 16 000 pillars) 3.2 + 14.1 MB,
// 5.2 us at 3.35 TB/s.  At that size both launches are a few microseconds
// of latency each, so the design keeps each one a single pass with no
// state across blocks.
//
// Design of phase 1: a block owns the pillars that start in its tile of
// TILE rows and reads a window of TILE + 64 rows, one a thread, so every
// owned pillar lies inside its window.  Two ballots give the pillars' first
// and last rows in the window; a row finds its pillar's extent from them.
// The sums run in shared memory, double buffered, one barrier a step; only
// a block's owned rows read their points.  Each row is written by one
// block: a valid row by the owner of its pillar, an invalid row by the
// block whose tile holds it.  Pillar slots past the count are zeroed by a
// grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CAP = 64;
constexpr int TILE = 192;  // rows whose pillars a block owns (phase 1;
                           // ops/voxelize_kernel.py:TILE, which the tests
                           // read, must match)
constexpr int WINDOW = TILE + MAX_CAP;  // one row a thread
constexpr int WORDS = WINDOW / 32;
constexpr int CAP_THREADS = 256;
constexpr int FEATS = 10;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(CAP_THREADS)
    voxel_cap_kernel(const int64_t* __restrict__ cell,
                     int64_t* __restrict__ key, int n, int cap,
                     int64_t sentinel) {
  const int i = blockIdx.x * CAP_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t c = cell[i];
  const bool capped = c != sentinel && (i < cap || cell[i - cap] != c);
  key[i] = capped ? c : sentinel;
}

// last set bit at or before t, or -1
__device__ __forceinline__ int prev_bit(const uint32_t* bits, int t) {
  for (int w = t >> 5; w >= 0; --w) {
    uint32_t m = bits[w];
    if (w == (t >> 5)) m &= (2u << (t & 31)) - 1u;
    if (m) return w * 32 + 31 - __clz(m);
  }
  return -1;
}

// first set bit at or after t, or WINDOW
__device__ __forceinline__ int next_bit(const uint32_t* bits, int t) {
  for (int w = t >> 5; w < WORDS; ++w) {
    uint32_t m = bits[w];
    if (w == (t >> 5)) m &= FULL << (t & 31);
    if (m) return w * 32 + __ffs(m) - 1;
  }
  return WINDOW;
}

// a cell's centre on one axis: (i + 0.5) * size + vmin in float64, each
// step rounded once, then rounded to f32 (ops/voxelize.py:centre)
__device__ __forceinline__ float centre(int64_t i, float size, float vmin) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(__dadd_rn(static_cast<double>(i), 0.5),
                static_cast<double>(size)),
      static_cast<double>(vmin)));
}

struct Grid {
  int gx, gy, gz, max_pillars;
  float vx, vy, vz, x0, y0, z0;
};

__global__ void __launch_bounds__(WINDOW)
    voxel_pillars_kernel(const int64_t* __restrict__ cell,
                         const int64_t* __restrict__ pid,
                         const float* __restrict__ points,
                         const int64_t* __restrict__ perm,
                         const int64_t* __restrict__ perm2, int rows, Grid g,
                         float* __restrict__ feats,
                         int64_t* __restrict__ pillar_of,
                         bool* __restrict__ kept_out,
                         int64_t* __restrict__ counts,
                         int64_t* __restrict__ coords,
                         bool* __restrict__ pillar_valid,
                         int64_t* __restrict__ pillar_count) {
  __shared__ int64_t sc[WINDOW];
  __shared__ uint32_t head_bits[WORDS], last_bits[WORDS];
  __shared__ float buf[2][3][WINDOW];

  const int t = threadIdx.x, lane = t & 31;
  const int t0 = blockIdx.x * TILE;
  const int r = t0 + t;
  const int64_t sentinel = static_cast<int64_t>(g.gx) * g.gy * g.gz;
  const int P = g.max_pillars;
  const int D = g.gz > 1 ? 3 : 2;

  // the registry past the count: pillar_valid everywhere, zeros past it
  const int64_t heads = rows > 0 ? pid[rows - 1] + 1 : 0;
  const int64_t pc = heads < P ? heads : P;
  for (int j = blockIdx.x * WINDOW + t; j < P; j += gridDim.x * WINDOW) {
    pillar_valid[j] = j < pc;
    if (j >= pc) {
      counts[j] = 0;
      for (int d = 0; d < D; ++d) coords[(int64_t)j * D + d] = 0;
    }
  }
  if (blockIdx.x == 0 && t == 0) *pillar_count = pc;

  const int64_t c = r < rows ? cell[r] : sentinel;
  const bool valid = c != sentinel;
  sc[t] = c;
  __syncthreads();
  // the plain version's neighbours: -1 before the first row and after the
  // last; rows past the stream read as the sentinel
  const int64_t prev = t > 0 ? sc[t - 1] : (r > 0 ? cell[r - 1] : -1);
  const int64_t next =
      t < WINDOW - 1 ? sc[t + 1] : (r + 1 < rows ? cell[r + 1] : -1);
  const uint32_t hb = __ballot_sync(FULL, valid && c != prev);
  const uint32_t lb = __ballot_sync(FULL, valid && c != next);
  if (lane == 0) {
    head_bits[t >> 5] = hb;
    last_bits[t >> 5] = lb;
  }
  __syncthreads();

  // the row's pillar in the window: its first row (-1: before the window)
  // and its last; owned when it starts in the tile
  const int start = prev_bit(head_bits, t);
  const int end = next_bit(last_bits, t);
  const bool owned = valid && start >= 0 && start < TILE && end < WINDOW;
  const int64_t p = owned ? pid[r] : 0;
  const bool kept = owned && p < P;
  const int rank = t - start;

  float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
  if (kept) {
    const float* q = points + perm[perm2[r]] * 4;
    x = q[0];
    y = q[1];
    z = q[2];
    w = q[3];
  }
  // segmented Hillis-Steele inclusive sums, as the plain version's steps
  float v[3] = {x, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a) buf[0][a][t] = v[a];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int s = 1 << k;
    const bool take = owned && rank >= s;
    const int from = take ? t - s : t;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = __fadd_rn(v[a], take ? buf[k & 1][a][from] : 0.f);
      buf[(k + 1) & 1][a][t] = v[a];
    }
    __syncthreads();
  }

  const bool writes = owned || (!valid && t < TILE && r < rows);
  if (!writes) return;
  float* f = feats + static_cast<int64_t>(r) * FEATS;
  if (kept) {
    // the pillar's totals at its last row, over its count
    const float cnt = fmaxf(static_cast<float>(end - start + 1), 1.f);
    float m[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = __fdiv_rn(buf[0][a][end], cnt);
    const int64_t ix = c % g.gx, q = c / g.gx;
    const int64_t iy = g.gz > 1 ? q % g.gy : q;
    const int64_t iz = g.gz > 1 ? q / g.gy : 0;
    f[0] = x;
    f[1] = y;
    f[2] = z;
    f[3] = w;
    f[4] = __fsub_rn(x, m[0]);
    f[5] = __fsub_rn(y, m[1]);
    f[6] = __fsub_rn(z, m[2]);
    f[7] = __fsub_rn(x, centre(ix, g.vx, g.x0));
    f[8] = __fsub_rn(y, centre(iy, g.vy, g.y0));
    f[9] = __fsub_rn(z, centre(iz, g.vz, g.z0));
    pillar_of[r] = p;
    kept_out[r] = true;
    if (rank == 0) {  // the pillar's head row registers it
      counts[p] = end - start + 1;
      int64_t* co = coords + p * D;
      if (D == 3) {
        co[0] = iz;
        co[1] = iy;
        co[2] = ix;
      } else {
        co[0] = q;
        co[1] = ix;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < FEATS; ++k) f[k] = 0.f;
    pillar_of[r] = P;
    kept_out[r] = false;
  }
}

}  // namespace

// phase 0: cell, n, cap, sentinel from the grid, key.  phase 1: the rest.
// Pointers a phase does not use may be null.
extern "C" int dsvt_voxel_segments(
    int phase, const void* cell, int rows, int cap, const void* pid,
    const void* points, const void* perm, const void* perm2, int gx, int gy,
    int gz, int max_pillars, float vx, float vy, float vz, float x0, float y0,
    float z0, void* key, void* feats, void* pillar_of, void* kept,
    void* counts, void* coords, void* pillar_valid, void* pillar_count,
    void* stream) {
  if (cap < 1 || cap > MAX_CAP || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t sentinel = static_cast<int64_t>(gx) * gy * gz;
  if (phase == 0) {
    if (rows == 0) return 0;
    voxel_cap_kernel<<<(rows + CAP_THREADS - 1) / CAP_THREADS, CAP_THREADS,
                       0, s>>>(
        static_cast<const int64_t*>(cell), static_cast<int64_t*>(key), rows,
        cap, sentinel);
  } else if (phase == 1) {
    const Grid g{gx, gy, gz, max_pillars, vx, vy, vz, x0, y0, z0};
    const int blocks = rows > 0 ? (rows + TILE - 1) / TILE : 1;
    voxel_pillars_kernel<<<blocks, WINDOW, 0, s>>>(
        static_cast<const int64_t*>(cell), static_cast<const int64_t*>(pid),
        static_cast<const float*>(points), static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(perm2), rows, g,
        static_cast<float*>(feats), static_cast<int64_t*>(pillar_of),
        static_cast<bool*>(kept), static_cast<int64_t*>(counts),
        static_cast<int64_t*>(coords), static_cast<bool*>(pillar_valid),
        static_cast<int64_t*>(pillar_count));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
