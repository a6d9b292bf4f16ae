// Native host-side builders of the port's acceleration structures.
//
// Copy of lens_flare_tpu/accel/native/builder.cpp for the PyTorch port:
// lf_build_bvh (the binary SAH BVH that kernel G walks, accel/bvh.py) and
// lf_build_wide (the two-level cluster tree of kernels A-F,
// accel/wide.py).  The same inputs give the same arrays as the JAX
// package's builders.  The NumPy builders in accel/bvh.py and
// accel/wide.py stay as the fallback where no g++ is found.
//
// C ABI only, loaded with ctypes.

#include <algorithm>
#include <cfloat>
#include <cmath>
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
  float area() const {
    float d0 = std::max(mx[0] - mn[0], 0.f);
    float d1 = std::max(mx[1] - mn[1], 0.f);
    float d2 = std::max(mx[2] - mn[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }
};

struct BuildCtx {
  const float* box_min;  // (N, 3)
  const float* box_max;
  std::vector<float> centroid;  // (N, 3)
  std::vector<int32_t> order;
  // output, emitted in DFS order
  std::vector<float> node_min, node_max;
  std::vector<int32_t> node_left, node_right, node_start, node_count;
  int max_depth = 0;
  int max_leaf = 4;
};

constexpr int kBins = 16;

int emit_node(BuildCtx& ctx, int lo, int hi, int depth) {
  Box bb;
  for (int i = lo; i < hi; ++i) {
    const int32_t p = ctx.order[i];
    bb.expand(ctx.box_min + 3 * p, ctx.box_max + 3 * p);
  }
  const int slot = static_cast<int>(ctx.node_left.size());
  for (int a = 0; a < 3; ++a) {
    ctx.node_min.push_back(bb.mn[a]);
  }
  for (int a = 0; a < 3; ++a) {
    ctx.node_max.push_back(bb.mx[a]);
  }
  ctx.node_left.push_back(-1);
  ctx.node_right.push_back(-1);
  ctx.node_start.push_back(lo);
  ctx.node_count.push_back(0);
  ctx.max_depth = std::max(ctx.max_depth, depth);

  const int count = hi - lo;
  if (count <= ctx.max_leaf) {
    ctx.node_count[slot] = count;
    return slot;
  }

  // binned SAH split
  float c_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float c_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = lo; i < hi; ++i) {
    const float* c = ctx.centroid.data() + 3 * ctx.order[i];
    for (int a = 0; a < 3; ++a) {
      c_lo[a] = std::min(c_lo[a], c[a]);
      c_hi[a] = std::max(c_hi[a], c[a]);
    }
  }

  float best_cost = FLT_MAX;
  int best_axis = -1, best_bin = -1;
  for (int axis = 0; axis < 3; ++axis) {
    const float extent = c_hi[axis] - c_lo[axis];
    if (extent <= 1e-12f) continue;
    const float scale = kBins / extent;
    Box bins[kBins];
    int counts[kBins] = {0};
    for (int i = lo; i < hi; ++i) {
      const int32_t p = ctx.order[i];
      int b = static_cast<int>((ctx.centroid[3 * p + axis] - c_lo[axis]) * scale);
      b = std::min(b, kBins - 1);
      bins[b].expand(ctx.box_min + 3 * p, ctx.box_max + 3 * p);
      counts[b]++;
    }
    Box right[kBins];
    Box acc;
    for (int b = kBins - 1; b >= 0; --b) {
      acc.expand(bins[b].mn, bins[b].mx);
      right[b] = acc;
    }
    Box left;
    int lcnt = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      left.expand(bins[b].mn, bins[b].mx);
      lcnt += counts[b];
      const int rcnt = count - lcnt;
      if (lcnt == 0 || rcnt == 0) continue;
      const float cost = left.area() * lcnt + right[b + 1].area() * rcnt;
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_bin = b;
      }
    }
  }

  int mid;
  if (best_axis < 0) {
    mid = lo + count / 2;
  } else {
    const float scale = kBins / (c_hi[best_axis] - c_lo[best_axis]);
    auto it = std::stable_partition(
        ctx.order.begin() + lo, ctx.order.begin() + hi, [&](int32_t p) {
          int b = static_cast<int>(
              (ctx.centroid[3 * p + best_axis] - c_lo[best_axis]) * scale);
          return std::min(b, kBins - 1) <= best_bin;
        });
    mid = static_cast<int>(it - ctx.order.begin());
    if (mid == lo || mid == hi) mid = lo + count / 2;
  }

  const int l = emit_node(ctx, lo, mid, depth + 1);
  ctx.node_left[slot] = l;
  const int r = emit_node(ctx, mid, hi, depth + 1);
  ctx.node_right[slot] = r;
  return slot;
}

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

// Binary SAH BVH.  Caller allocates outputs for up to 2*N nodes.
// Returns the number of nodes emitted; *out_max_depth gets the tree depth.
int lf_build_bvh(const float* box_min, const float* box_max, int n,
                 int max_leaf, float* node_min, float* node_max,
                 int32_t* node_left, int32_t* node_right, int32_t* node_start,
                 int32_t* node_count, int32_t* prim_order,
                 int32_t* out_max_depth) {
  BuildCtx ctx;
  ctx.box_min = box_min;
  ctx.box_max = box_max;
  ctx.max_leaf = max_leaf;
  ctx.centroid.resize(3 * n);
  for (int i = 0; i < 3 * n; ++i) {
    ctx.centroid[i] = 0.5f * (box_min[i] + box_max[i]);
  }
  ctx.order.resize(n);
  std::iota(ctx.order.begin(), ctx.order.end(), 0);
  const size_t cap = std::max(2 * n, 1);
  ctx.node_min.reserve(3 * cap);
  ctx.node_max.reserve(3 * cap);

  emit_node(ctx, 0, n, 1);

  const int m = static_cast<int>(ctx.node_left.size());
  std::memcpy(node_min, ctx.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(node_max, ctx.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(node_left, ctx.node_left.data(), sizeof(int32_t) * m);
  std::memcpy(node_right, ctx.node_right.data(), sizeof(int32_t) * m);
  std::memcpy(node_start, ctx.node_start.data(), sizeof(int32_t) * m);
  std::memcpy(node_count, ctx.node_count.data(), sizeof(int32_t) * m);
  std::memcpy(prim_order, ctx.order.data(), sizeof(int32_t) * n);
  *out_max_depth = ctx.max_depth;
  return m;
}

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
