// Native host runtime of the PyTorch/CUDA DSVT port (the port's own copy of
// the JAX package's native/dsvt_host.cpp, same functions and ABI).
//
// Plays the role the reference's C++ host code plays around its engine
// (include/helper.h): point-cloud .bin loading, the text .wts checkpoint
// parser, and greedy rotated-BEV NMS.  The compute path runs on the card;
// this library keeps the host-side I/O and the host NMS native.
//
// Build: dsvt_ai_trt_tpu_torch/io/host_nms.py compiles it on first use with
// g++ -O3 -std=c++17 -fPIC -shared into build/native/<digest>/libdsvt_host.so
// and binds it with ctypes.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <fstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Point cloud loading: raw float32 (x,y,z,i) rows, zero-padded to capacity.
// Returns the point count, or -1 on error. buf must hold max_points*4 floats.
// ---------------------------------------------------------------------------
int dsvt_load_bin(const char* path, float* buf, int max_points) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % (4 * sizeof(float)) != 0) {
    std::fclose(f);
    return -1;
  }
  long n = bytes / (4 * sizeof(float));
  if (n > max_points) n = max_points;
  std::memset(buf, 0, sizeof(float) * 4 * max_points);
  size_t got = std::fread(buf, sizeof(float) * 4, n, f);
  std::fclose(f);
  return (int)got;
}

// ---------------------------------------------------------------------------
// .wts checkpoint parsing (text: count line, then "name len hex hex ...",
// big-endian float words — the format written by the reference's
// tools/gen_wts.py).  Converts to a binary blob + text index in one pass so
// Python can memmap it: blob = little-endian float32 concatenation, index
// lines are "name offset count".  Returns tensor count, or -1 on error.
// ---------------------------------------------------------------------------
static inline int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

int dsvt_wts_to_blob(const char* wts_path, const char* blob_path,
                     const char* index_path) {
  std::ifstream in(wts_path);
  if (!in.is_open()) return -1;
  std::ofstream blob(blob_path, std::ios::binary);
  std::ofstream index(index_path);
  if (!blob.is_open() || !index.is_open()) return -1;

  long count = 0;
  in >> count;
  if (count <= 0) return -1;

  uint64_t offset = 0;
  std::string name, word;
  std::vector<float> vals;
  for (long t = 0; t < count; ++t) {
    uint64_t n = 0;
    in >> name >> n;
    if (!in.good()) return -1;
    vals.resize(n);
    for (uint64_t i = 0; i < n; ++i) {
      in >> word;
      uint32_t v = 0;
      for (char c : word) {
        int h = hexval(c);
        if (h < 0) return -1;
        v = (v << 4) | (uint32_t)h;
      }
      float fv;
      std::memcpy(&fv, &v, 4);
      vals[i] = fv;
    }
    blob.write(reinterpret_cast<const char*>(vals.data()), n * sizeof(float));
    index << name << " " << offset << " " << n << "\n";
    offset += n;
  }
  return (int)count;
}

// ---------------------------------------------------------------------------
// Greedy rotated-BEV NMS.  Boxes are rows of 9 floats
// (x, y, z, dim0, dim1, dz, heading, class, score) sorted by descending
// score.  The rectangle convention matches the pipeline: half-extent dim1/2
// along the box's local x axis, dim0/2 along local y, rotated by +heading.
// Intersection area via Sutherland–Hodgman convex clipping.
// keep[] receives 0/1 flags; returns the number kept.
// ---------------------------------------------------------------------------
struct Pt {
  double x, y;
};

static void rect_corners(const float* b, Pt* out) {
  double cx = b[0], cy = b[1];
  double hx = b[4] * 0.5, hy = b[3] * 0.5;
  double c = std::cos((double)b[6]), s = std::sin((double)b[6]);
  const double ox[4] = {-hx, hx, hx, -hx};
  const double oy[4] = {-hy, -hy, hy, hy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = ox[i] * c - oy[i] * s + cx;
    out[i].y = ox[i] * s + oy[i] * c + cy;
  }
}

// clip polygon `poly` by the half-plane left of edge a->b
static int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    Pt cur = poly[i];
    Pt nxt = poly[(i + 1) % n];
    double dcur = (b.x - a.x) * (cur.y - a.y) - (b.y - a.y) * (cur.x - a.x);
    double dnxt = (b.x - a.x) * (nxt.y - a.y) - (b.y - a.y) * (nxt.x - a.x);
    if (dcur >= 0) out[m++] = cur;
    if ((dcur >= 0) != (dnxt >= 0)) {
      double t = dcur / (dcur - dnxt);
      out[m].x = cur.x + t * (nxt.x - cur.x);
      out[m].y = cur.y + t * (nxt.y - cur.y);
      ++m;
    }
  }
  return m;
}

static double quad_intersection_area(const Pt* pa, const Pt* pb) {
  Pt buf1[16], buf2[16];
  std::memcpy(buf1, pa, 4 * sizeof(Pt));
  int n = 4;
  Pt* src = buf1;
  Pt* dst = buf2;
  for (int e = 0; e < 4 && n > 2; ++e) {
    n = clip_edge(src, n, pb[e], pb[(e + 1) % 4], dst);
    std::swap(src, dst);
  }
  if (n < 3) return 0.0;
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    area += src[i].x * src[j].y - src[j].x * src[i].y;
  }
  return std::fabs(area) * 0.5;
}

static double rect_intersection_area(const float* a, const float* b) {
  Pt pa[4], pb[4];
  rect_corners(a, pa);
  rect_corners(b, pb);
  return quad_intersection_area(pa, pb);
}

// Corners are built once per box.  With iou_thresh > 0, a pair whose
// circumcircles lie apart (with a 1 mm margin) cannot overlap, so its IoU of
// 0 is not computed: the kept set is the one every pair's clip would give
// (the NumPy route, io/host_nms.py:_nms_numpy, skips the same pairs).
int dsvt_nms(const float* boxes, int n, float iou_thresh, int* keep) {
  std::vector<char> suppressed(n, 0);
  std::vector<Pt> corners(4 * (size_t)n);
  std::vector<double> area(n), radius(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + i * 9;
    rect_corners(b, &corners[4 * (size_t)i]);
    area[i] = (double)b[3] * b[4];
    radius[i] = 0.5 * std::hypot((double)b[3], (double)b[4]);
  }
  int kept = 0;
  for (int i = 0; i < n; ++i) {
    keep[i] = 0;
    if (suppressed[i]) continue;
    keep[i] = 1;
    ++kept;
    const float* bi = boxes + i * 9;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 9;
      if (iou_thresh > 0 &&
          std::hypot((double)bi[0] - bj[0], (double)bi[1] - bj[1]) >
              radius[i] + radius[j] + 1e-3)
        continue;
      double ov = quad_intersection_area(&corners[4 * (size_t)i],
                                         &corners[4 * (size_t)j]);
      double iou = ov / std::max(area[i] + area[j] - ov, 1e-8);
      if (iou >= iou_thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Pairwise rotated intersection areas (for tests / offline eval).
void dsvt_pairwise_overlap(const float* boxes, int n, float* out) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      out[i * n + j] =
          (i == j) ? 0.f : (float)rect_intersection_area(boxes + i * 9,
                                                         boxes + j * 9);
}

}  // extern "C"
