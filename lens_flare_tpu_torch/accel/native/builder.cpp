// Native host-side builder of the two-level wide cluster tree.
//
// Copy of the wide builder in lens_flare_tpu/accel/native/builder.cpp
// (lf_build_wide and its median partition), for the PyTorch port's
// accel/wide.py: the same inputs give the same arrays.  The NumPy builder
// in accel/wide.py stays as the fallback where no g++ is found.
//
// C ABI only, loaded with ctypes.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <utility>
#include <vector>

namespace {

struct Box {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void expand(const float* lo, const float* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
};

// recursive largest-axis median split into `parts` (power of two) chunks
void median_partition(const float* centroid, int32_t* order, int n, int parts,
                      std::vector<std::pair<int, int>>& out, int off) {
  if (parts == 1 || n <= 1) {
    out.emplace_back(off, n);
    // fill remaining slots with empties
    for (int i = 1; i < parts; ++i) out.emplace_back(off + n, 0);
    return;
  }
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = 0; i < n; ++i) {
    const float* c = centroid + 3 * order[i];
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], c[a]);
      hi[a] = std::max(hi[a], c[a]);
    }
  }
  int axis = 0;
  float best = hi[0] - lo[0];
  for (int a = 1; a < 3; ++a) {
    if (hi[a] - lo[a] > best) {
      best = hi[a] - lo[a];
      axis = a;
    }
  }
  const int half = (n + 1) / 2;
  std::nth_element(order, order + half, order + n, [&](int32_t x, int32_t y) {
    const float cx = centroid[3 * x + axis];
    const float cy = centroid[3 * y + axis];
    return cx < cy || (cx == cy && x < y);
  });
  median_partition(centroid, order, half, parts / 2, out, off);
  median_partition(centroid, order + half, n - half, parts / 2, out, off + half);
}

}  // namespace

extern "C" {

// Two-level wide cluster tree (layout of accel/wide.py).
// tri_verts: (n, 3, 3) row-major corner positions.
// Outputs: top_boxes (b1, 8), child_boxes (b1*b2, 8), tri_soa (b1*b2*k, 12),
// tri_id (b1*b2*k).  Returns 0 on success, -1 on cluster overflow.
int lf_build_wide(const float* tri_verts, int n, int b1, int b2, int k,
                  float* top_boxes, float* child_boxes, float* tri_soa,
                  int32_t* tri_id) {
  std::vector<float> bmin(3 * std::max(n, 1)), bmax(3 * std::max(n, 1)),
      cent(3 * std::max(n, 1));
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      const float v0 = tri_verts[9 * i + a];
      const float v1 = tri_verts[9 * i + 3 + a];
      const float v2 = tri_verts[9 * i + 6 + a];
      const float lo = std::min(v0, std::min(v1, v2));
      const float hi = std::max(v0, std::max(v1, v2));
      bmin[3 * i + a] = lo;
      bmax[3 * i + a] = hi;
      cent[3 * i + a] = 0.5f * (lo + hi);
    }
  }

  // init: empty boxes fail the slab test (min > max)
  for (int t = 0; t < b1; ++t) {
    for (int a = 0; a < 3; ++a) {
      top_boxes[8 * t + a] = 1.f;
      top_boxes[8 * t + 3 + a] = -1.f;
    }
    top_boxes[8 * t + 6] = top_boxes[8 * t + 7] = 0.f;
  }
  for (int c = 0; c < b1 * b2; ++c) {
    for (int a = 0; a < 3; ++a) {
      child_boxes[8 * c + a] = 1.f;
      child_boxes[8 * c + 3 + a] = -1.f;
    }
    child_boxes[8 * c + 6] = child_boxes[8 * c + 7] = 0.f;
  }
  std::memset(tri_soa, 0, sizeof(float) * 12 * b1 * b2 * k);
  std::fill(tri_id, tri_id + b1 * b2 * k, -1);
  if (n == 0) return 0;

  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::vector<std::pair<int, int>> tops;
  median_partition(cent.data(), order.data(), n, b1, tops, 0);

  for (int t = 0; t < b1 && t < static_cast<int>(tops.size()); ++t) {
    const auto [off, cnt] = tops[t];
    if (cnt == 0) continue;
    Box tb;
    for (int i = off; i < off + cnt; ++i) {
      tb.expand(bmin.data() + 3 * order[i], bmax.data() + 3 * order[i]);
    }
    for (int a = 0; a < 3; ++a) {
      top_boxes[8 * t + a] = tb.mn[a];
      top_boxes[8 * t + 3 + a] = tb.mx[a];
    }
    std::vector<std::pair<int, int>> subs;
    median_partition(cent.data(), order.data() + off, cnt, b2, subs, off);
    for (int c = 0; c < b2 && c < static_cast<int>(subs.size()); ++c) {
      const auto [soff, scnt] = subs[c];
      if (scnt == 0) continue;
      if (scnt > k) return -1;
      const int node = t * b2 + c;
      Box cb;
      for (int i = soff; i < soff + scnt; ++i) {
        cb.expand(bmin.data() + 3 * order[i], bmax.data() + 3 * order[i]);
      }
      for (int a = 0; a < 3; ++a) {
        child_boxes[8 * node + a] = cb.mn[a];
        child_boxes[8 * node + 3 + a] = cb.mx[a];
      }
      for (int s = 0; s < scnt; ++s) {
        const int32_t prim = order[soff + s];
        float* dst = tri_soa + 12 * (node * k + s);
        const float* src = tri_verts + 9 * prim;
        for (int a = 0; a < 3; ++a) {
          dst[a] = src[a];                    // p0
          dst[3 + a] = src[3 + a] - src[a];   // e1
          dst[6 + a] = src[6 + a] - src[a];   // e2
        }
        tri_id[node * k + s] = prim;
      }
    }
  }
  return 0;
}

}  // extern "C"
