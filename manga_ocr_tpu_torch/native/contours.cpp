// Native host-side mask ops for the detection pipeline (the port's copy of
// manga_ocr_tpu/native/contours.cpp).
//
// Contours have data-dependent output shapes, so they run on the host while
// the card produces masks in batched dispatches (SURVEY §7.4).  This library
// implements the three hot host ops -- external-contour tracing (Moore
// border following), scanline polygon fill, and box dilation -- as a C ABI
// consumed via ctypes.
//
// Built with prep.cpp into one library by manga_ocr_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Point {
  int32_t x, y;
};

// Moore-neighborhood border following, clockwise, starting west.
// Traces the outer boundary of the connected component containing `start`.
void moore_trace(const uint8_t* mask, int h, int w, int sy, int sx,
                 std::vector<Point>* out) {
  static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  static const int dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
  auto is_set = [&](int y, int x) {
    return y >= 0 && y < h && x >= 0 && x < w && mask[y * w + x] != 0;
  };
  out->push_back({sx, sy});
  int cy = sy, cx = sx;
  int prev_dir = 4;  // came from the left
  const long limit = static_cast<long>(h) * w * 4;
  for (long it = 0; it < limit; ++it) {
    bool found = false;
    for (int i = 0; i < 8; ++i) {
      int d = (prev_dir + 6 + i) % 8;  // backtrack then clockwise
      int ny = cy + dy[d], nx = cx + dx[d];
      if (is_set(ny, nx)) {
        cy = ny;
        cx = nx;
        prev_dir = d;
        if (cy == sy && cx == sx) return;
        out->push_back({cx, cy});
        found = true;
        break;
      }
    }
    if (!found) return;  // isolated pixel
  }
}

}  // namespace

extern "C" {

// Trace external contours of a 0/nonzero mask.
//  mask:   h*w uint8
//  out_xy: caller buffer for concatenated (x, y) int32 pairs, cap `max_pts`
//  out_sizes: caller buffer for per-contour point counts, cap `max_contours`
// Returns the number of contours written (negative on overflow).
int32_t trace_external_contours(const uint8_t* mask, int32_t h, int32_t w,
                                int32_t* out_xy, int64_t max_pts,
                                int32_t* out_sizes, int32_t max_contours) {
  std::vector<int32_t> comp(static_cast<size_t>(h) * w, 0);
  std::vector<int32_t> stack;
  int32_t ncomp = 0;
  int64_t pts_used = 0;
  int32_t contours = 0;
  std::vector<Point> poly;

  for (int32_t sy = 0; sy < h; ++sy) {
    for (int32_t sx = 0; sx < w; ++sx) {
      if (!mask[sy * w + sx] || comp[sy * w + sx]) continue;
      ++ncomp;
      // BFS-label the component (8-connected) so we trace each once.
      stack.clear();
      stack.push_back(sy * w + sx);
      comp[sy * w + sx] = ncomp;
      while (!stack.empty()) {
        int32_t p = stack.back();
        stack.pop_back();
        int32_t cy = p / w, cx = p % w;
        for (int ddy = -1; ddy <= 1; ++ddy) {
          for (int ddx = -1; ddx <= 1; ++ddx) {
            int32_t ny = cy + ddy, nx = cx + ddx;
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            int32_t q = ny * w + nx;
            if (mask[q] && !comp[q]) {
              comp[q] = ncomp;
              stack.push_back(q);
            }
          }
        }
      }
      poly.clear();
      moore_trace(mask, h, w, sy, sx, &poly);
      if (poly.size() < 3) continue;
      if (contours >= max_contours ||
          pts_used + static_cast<int64_t>(poly.size()) > max_pts) {
        return -contours;  // overflow: caller should grow buffers
      }
      for (const Point& p : poly) {
        out_xy[2 * pts_used] = p.x;
        out_xy[2 * pts_used + 1] = p.y;
        ++pts_used;
      }
      out_sizes[contours++] = static_cast<int32_t>(poly.size());
    }
  }
  return contours;
}

// Scanline polygon fill (even-odd rule) into an existing mask.
void fill_polygon(uint8_t* mask, int32_t h, int32_t w, const int32_t* xy,
                  int32_t n, uint8_t value) {
  if (n < 3) return;
  int32_t ymin = h, ymax = -1;
  for (int32_t i = 0; i < n; ++i) {
    int32_t y = xy[2 * i + 1];
    if (y < ymin) ymin = y;
    if (y > ymax) ymax = y;
  }
  if (ymin < 0) ymin = 0;
  if (ymax >= h) ymax = h - 1;
  std::vector<double> xs;
  for (int32_t y = ymin; y <= ymax; ++y) {
    xs.clear();
    int32_t j = n - 1;
    for (int32_t i = 0; i < n; ++i) {
      double yi = xy[2 * i + 1], yj = xy[2 * j + 1];
      double xi = xy[2 * i], xj = xy[2 * j];
      if ((yi > y) != (yj > y)) {
        xs.push_back(xi + (y - yi) / (yj - yi) * (xj - xi));
      }
      j = i;
    }
    if (xs.size() < 2) continue;
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      // inclusive span [ceil(x0), floor(x1)] — matches the cv2 fill within
      // a boundary pixel (tested)
      int32_t a = static_cast<int32_t>(std::ceil(xs[k]));
      int32_t b = static_cast<int32_t>(std::floor(xs[k + 1]));
      if (a < 0) a = 0;
      if (b >= w) b = w - 1;
      for (int32_t x = a; x <= b; ++x) mask[y * w + x] = value;
    }
  }
}

// Box dilation by `radius` (separable two-pass running max).
void dilate_box(const uint8_t* src, uint8_t* dst, int32_t h, int32_t w,
                int32_t radius) {
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * w, 0);
  // horizontal pass
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w;
    uint8_t* out = tmp.data() + static_cast<size_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      uint8_t m = 0;
      int32_t a = x - radius < 0 ? 0 : x - radius;
      int32_t b = x + radius >= w ? w - 1 : x + radius;
      for (int32_t k = a; k <= b; ++k)
        if (row[k] > m) m = row[k];
      out[x] = m;
    }
  }
  // vertical pass
  for (int32_t y = 0; y < h; ++y) {
    uint8_t* out = dst + static_cast<size_t>(y) * w;
    int32_t a = y - radius < 0 ? 0 : y - radius;
    int32_t b = y + radius >= h ? h - 1 : y + radius;
    for (int32_t x = 0; x < w; ++x) {
      uint8_t m = 0;
      for (int32_t k = a; k <= b; ++k) {
        uint8_t v = tmp[static_cast<size_t>(k) * w + x];
        if (v > m) m = v;
      }
      out[x] = m;
    }
  }
}

}  // extern "C"
