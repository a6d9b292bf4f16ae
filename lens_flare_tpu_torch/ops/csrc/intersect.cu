// Ray / triangle / sphere intersection kernels for Hopper (sm_90a).
//
// These replace the Pallas TPU kernel family of
// lens_flare_tpu/ops/intersect_pallas.py, all reached through _launch
// (intersect_pallas.py:1267) and pl.pallas_call:
//
//   A  lf_tree_closest  <- _make_kernel(any_hit=False)        :214, call :1392
//                          (VMEM mode and the HBM-streaming mode, stream=True;
//                          chunk batch 2 on single-level trees; warp per ray)
//   B  lf_tree_any_hit  <- _make_kernel(any_hit=True)         :214, call :1392
//                          (VMEM and stream modes; warp per ray)
//   D  lf_tree_closest_shade <- _make_kernel(shade=True)      :214, call :1392
//                          (VMEM mode and stream_shade; warp per ray): A's
//                          results at chunk batch 1, plus the winning
//                          triangle slot's shading row
//   C  lf_brute         <- _make_brute_kernel(any_hit=True)   :877, call :1292
//                          (closest=1 selects _make_brute_kernel(any_hit=False);
//                          rows in shared memory)
//   E  lf_tree_closest_mxu <- _make_kernel(mxu=True)          :214, walk :559-629,
//                          features mxu_fmat :310-332, coefficient planes
//                          PallasScene.__init__ :1153-1214, call :1392
//                          (warp per ray; packed 160-byte coefficient rows)
//   F  lf_tree_group    <- _make_kernel(top_batch>1)          :214, group_body
//                          :699-799, any-hit exit :803-816, call :1392
//                          (closest hit, any hit and shade: three instances;
//                          warp per ray)
//   _sphere_pass (:840) runs at the end of every kernel.
//
// and one kernel that replaces XLA code, not a Pallas kernel:
//
//   G  lf_bvh_walk      <- lens_flare_tpu/ops/intersect.py:152 _make_traverse
//                          (intersect_rays :262, occluded_rays :331): the
//                          binary-BVH stack walk the JAX package takes past
//                          the cluster tree's capacity (one ray per thread
//                          in persistent warps over child-pair records,
//                          closest hit and any hit: two instances)
//
// Every kernel walks the same two-level cluster tree (accel/wide.py: B1 top
// boxes, B1*B2 child boxes, K triangles per child) from global memory.  The
// TPU walked a 512-2048-lane tile in lockstep and culled whole clusters per
// tile; its VMEM residency and HBM page ring have no counterpart here: the
// tree is 48 bytes per triangle slot plus 32 per box (25 MB of triangle rows
// and 0.5 MB of boxes for the 524k-triangle terrain), which sits mostly in
// the 50 MB L2.
//
// Two designs, both for this card rather than carried over from the TPU's
// per-lane walk:
// - A, B, D, E and F, one warp per ray (warp_walk_kernel and E's
//   mxu_walk_kernel through walk_tree; F's group_walk_kernel with its list
//   and continuation passes).  What bounded them as one thread per ray was
//   latency, not bytes or operations: a 64k-lane wavefront gave only 2,048
//   warps, each thread ran a long chain of dependent scalar loads from
//   addresses private to it, and a warp ran the union of its 32 rays' tops
//   and chunks.  A warp now walks one ray: its lanes test 32 top or child
//   boxes at once (two float4 each) and one slot each of a chunk (three
//   float4 of the 48-byte triangle row; E ten float4 of its 160-byte
//   coefficient row), so every load coalesces, a 64k-lane call has 65,536
//   warps, and no lane waits on another ray's path.  Ballots pick the boxes
//   hit and warp shuffles reduce a chunk in the sequential order (see
//   warp_walk_kernel).
// - C, the tree-free pass: every triangle row staged once per block in
//   shared memory, one ray per thread (see brute_kernel).
//
// Semantics kept from the Pallas kernels (see intersect_cuda.py for the
// plain PyTorch version of each kernel, held to bit equality on the card):
// - per-lane primitive-test counter: K per child box hit, the child mask
//   fixed at the start of each top with t_clip = min(t_hi, best_t)
//   (closest hit) or 0 once occluded (any hit); s_real per live lane in a
//   live 1024-lane tile (brute); +n_spheres from the sphere pass;
// - ties: within one chunk batch the highest slot id (and the highest b1,
//   b2) among equal t wins; across batches the earliest (strict <);
// - arithmetic: _box_hits' dead-lane term t_lo <= t_hi, _safe_inv's 1e-12
//   clamp, closest hit's det == 0 -> 1e-30, any hit's divide-free tests.
// Build with --fmad=false so products and sums round as the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KINF 3.0e38f
#define BRUTE_TILE 1024
#define BRUTE_BLOCK 64
#define BRUTE_MAX_TRIS 512  // intersect_pallas.py:102
#define MXU_FEATURES 10

namespace {

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float t_lo;
  float t_hi;
  bool finite;  // no NaN among o, d, t_lo, t_hi
};

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  return 1.0f / (d >= 0.0f ? fmaxf(d, eps) : fminf(d, -eps));
}

// NaN-propagating min, as torch.minimum / jnp.minimum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ t_lo,
                                        const float* __restrict__ t_hi, int i) {
  Ray r;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[3 * i + a];
    r.d[a] = d[3 * i + a];
    r.inv[a] = safe_inv(r.d[a]);
    ok = ok && !isnan(r.o[a]) && !isnan(r.d[a]);
  }
  r.t_lo = t_lo[i];
  r.t_hi = t_hi[i];
  r.finite = ok && !isnan(r.t_lo) && !isnan(r.t_hi);
  return r;
}

// _box_hits (intersect_pallas.py:142-159) for one box [min.xyz, max.xyz, pad, pad].
// A NaN anywhere in the ray makes every comparison of the plain version false,
// so such rays miss every box (checked once per ray in r.finite).
__device__ __forceinline__ bool box_hit(const float* __restrict__ b, const Ray& r, float t_lo,
                                        float t_hi) {
  float t_min = -KINF;
  float t_max = KINF;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (b[a] - r.o[a]) * r.inv[a];
    float t2 = (b[3 + a] - r.o[a]) * r.inv[a];
    t_min = fmaxf(t_min, fminf(t1, t2));
    t_max = fminf(t_max, fmaxf(t1, t2));
  }
  return (t_min <= t_max) && (t_max >= t_lo) && (t_min <= t_hi) && (t_lo <= t_hi);
}

// box_hit on a 16-byte aligned box, read as two float4.
__device__ __forceinline__ bool box_hit4(const float* __restrict__ b, const Ray& r, float t_lo,
                                         float t_hi) {
  const float4 p = __ldg(reinterpret_cast<const float4*>(b));
  const float4 q = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float v[6] = {p.x, p.y, p.z, p.w, q.x, q.y};
  return box_hit(v, r, t_lo, t_hi);
}

// Moller-Trumbore numerators for one triangle row [p0 | e1 | e2].
struct MT {
  float det, tt_n, bb1_n, bb2_n;
};

__device__ __forceinline__ MT mt_terms(const float* __restrict__ tri, const Ray& r) {
  const float p0x = tri[0], p0y = tri[1], p0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float sx = r.o[0] - p0x, sy = r.o[1] - p0y, sz = r.o[2] - p0z;
  const float s1x = r.d[1] * e2z - r.d[2] * e2y;
  const float s1y = r.d[2] * e2x - r.d[0] * e2z;
  const float s1z = r.d[0] * e2y - r.d[1] * e2x;
  const float s2x = sy * e1z - sz * e1y;
  const float s2y = sz * e1x - sx * e1z;
  const float s2z = sx * e1y - sy * e1x;
  MT m;
  m.det = s1x * e1x + s1y * e1y + s1z * e1z;
  m.tt_n = s2x * e2x + s2y * e2y + s2z * e2z;
  m.bb1_n = s1x * sx + s1y * sy + s1z * sz;
  m.bb2_n = s2x * r.d[0] + s2y * r.d[1] + s2z * r.d[2];
  return m;
}

// mt_terms on a 16-byte aligned 12-float row, read as three float4.
__device__ __forceinline__ MT mt_terms4(const float* __restrict__ tri, const Ray& r) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(tri));
  const float4 b = __ldg(reinterpret_cast<const float4*>(tri) + 1);
  const float4 c = __ldg(reinterpret_cast<const float4*>(tri) + 2);
  const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  return mt_terms(v, r);
}

// Divide-free occlusion test (intersect_pallas.py:459-484).
__device__ __forceinline__ bool occludes(const MT& m, float t_lo, float t_hi) {
  const float sgn = m.det >= 0.0f ? 1.0f : -1.0f;
  const float adet = m.det * sgn;
  const float tts = m.tt_n * sgn;
  const float b1s = m.bb1_n * sgn;
  const float b2s = m.bb2_n * sgn;
  return (adet > 0.0f) && (tts >= t_lo * adet) && (tts <= t_hi * adet) && (b1s >= 0.0f) &&
         (b1s <= adet) && (b2s >= 0.0f) && (b2s <= adet) && (b1s + b2s <= adet);
}

// Closest-hit chunk-batch state: the batch minimum t and, among slots tied
// at it, the max slot id and max barycentrics (intersect_pallas.py:505-523).
struct Batch {
  float t;
  int id;
  float b1, b2;
  float limit;  // min(t_hi, best_t) at the start of the batch
};

__device__ __forceinline__ void batch_reset(Batch& bt, float t_hi, float best_t) {
  bt.t = KINF;
  bt.id = -1;
  bt.b1 = -KINF;
  bt.b2 = -KINF;
  bt.limit = min_nan(t_hi, best_t);
}

// Closest-hit conditions of one slot (intersect_pallas.py:486-503): whether
// it is a valid hit in [t_lo, limit], with its t and barycentrics.
__device__ __forceinline__ bool closest_terms(const MT& m, float t_lo, float limit, float& tt,
                                              float& b1, float& b2) {
  const float inv_det = 1.0f / (m.det == 0.0f ? 1e-30f : m.det);
  tt = m.tt_n * inv_det;
  b1 = m.bb1_n * inv_det;
  b2 = m.bb2_n * inv_det;
  return (m.det != 0.0f) && (tt >= t_lo) && (tt <= limit) && (b1 >= 0.0f) && (b1 <= 1.0f) &&
         (b2 >= 0.0f) && (b2 <= 1.0f) && (b1 + b2 <= 1.0f);
}

__device__ __forceinline__ void batch_test(Batch& bt, const MT& m, int id, float t_lo) {
  float tt, b1, b2;
  if (!closest_terms(m, t_lo, bt.limit, tt, b1, b2)) return;
  if (tt < bt.t) {
    bt.t = tt;
    bt.id = id;
    bt.b1 = b1;
    bt.b2 = b2;
  } else if (tt == bt.t) {
    bt.id = max(bt.id, id);
    bt.b1 = fmaxf(bt.b1, b1);
    bt.b2 = fmaxf(bt.b2, b2);
  }
}

__device__ __forceinline__ void batch_commit(const Batch& bt, float& best_t, int& slot, float& ob1,
                                             float& ob2) {
  if (bt.t < best_t) {
    best_t = bt.t;
    slot = bt.id;
    ob1 = bt.b1;
    ob2 = bt.b2;
  }
}

// _sphere_pass (intersect_pallas.py:840-874): brute quadratic per sphere,
// then +n_spheres tests.
__device__ __forceinline__ void sphere_pass(const float* __restrict__ sph, int n_spheres,
                                            int base_slot, const Ray& r, float& best_t, int& slot,
                                            int& tests) {
  for (int s = 0; s < n_spheres; ++s) {
    const float* c = sph + 8 * s;
    const float ocx = r.o[0] - c[0], ocy = r.o[1] - c[1], ocz = r.o[2] - c[2];
    const float a = r.d[0] * r.d[0] + r.d[1] * r.d[1] + r.d[2] * r.d[2];
    const float bq = 2.0f * (ocx * r.d[0] + ocy * r.d[1] + ocz * r.d[2]);
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - c[3] * c[3];
    const float disc = bq * bq - 4.0f * a * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t1 = (-bq - sq) / (2.0f * a);
    const float t2 = (-bq + sq) / (2.0f * a);
    const float limit = min_nan(r.t_hi, best_t);
    const bool t1_ok = (t1 >= r.t_lo) && (t1 <= limit);
    const bool t2_ok = (t2 >= r.t_lo) && (t2 <= limit);
    const float ts = t1_ok ? t1 : t2;
    const bool valid = (disc >= 0.0f) && (t1_ok || t2_ok);
    if (valid && ts < best_t) {
      best_t = ts;
      slot = base_slot + s;
    }
  }
  tests += n_spheres;
}

// Kernels A, B, D and E: one warp walks one ray.  The result is the sequential
// walk's (the plain version tree_plain), bit for bit and with the same
// per-lane tests; only who does which test changes.
//
// 1. Tops go in words of 32, one per lane.  A ballot of each lane's top box
//    under [t_lo, hi_pre], the loosest clip the walk can use (t_hi; for any
//    hit max(t_hi, 0)), gives the candidates: the slab test is monotone in
//    the clip, so a top that is missed there is missed under every clip.
// 2. The candidates go in ascending order.  The clip is fixed at the top's
//    start (min(t_hi, best_t); for any hit t_hi, or 0 once occluded), and a
//    candidate is tested again, warp-uniformly, where the clip is tighter.
// 3. The top's children go in words of 32 (walk_top): a ballot of the child
//    boxes hit under the clip, K tests charged per set bit, then each set
//    child's chunk in ascending order, one slot per lane in strides of 32
//    (K != 32 masks or loops).
// 4. Closest hit: the hit chunks of a top go in batches of CB (chunk batch,
//    2 on single-level trees for A, else 1), in hit order and across child
//    words.  A batch's limit is min(t_hi, best_t) at its start; each
//    chunk's stride takes the warp's minimum t (fminf butterfly), then a
//    ballot of the slots tied at it, merged into the batch's state exactly as
//    batch_test's sequential update would: the first tied slot's t (its sign
//    of zero too), the highest tied slot id, and fmaxf over the tied
//    barycentrics in ascending slot order.  The batch commits where its t
//    beats best_t, after every CB-th hit chunk and at the top's end.  Any
//    hit: __any_sync; once occluded, the top's charged tests stand, and the
//    walk goes on under [t_lo, 0] only where t_lo <= 0.
// 5. A ray with a NaN or an empty interval (t_lo > t_hi) hits no box under
//    any clip: it skips the walk in one uniform branch.
// 6. D (SHADE) takes the winner's 10-float row before the sphere pass
//    (lanes 0-9 copy one float each, zeros where no triangle won), as the
//    TPU kernel's one-hot select did (intersect_pallas.py:524-542,
//    :843-847).  Every lane then runs the sphere pass on the same values;
//    lane 0 writes the outputs.
//
// The TPU walked tiles of rays in lockstep because its vector unit is wide
// and its cost is per tile; a packet of rays per warp would bring back the
// divergence that this design removes, since the bounce and shadow
// wavefronts of the main path are incoherent and every ray keeps its own
// clip per top.  What bounds the walk now is latency: each ray is a chain
// of dependent L2 round trips (ray, top words, child words, chunks), hidden
// only by the ~36-40 warps an SM keeps resident at 48-56 registers.  Of 2,
// 4, 8 and 16 rays per block, 4 measured fastest over the main path's
// wavefronts; holding the next chunk's rows in registers ahead of time (74
// registers, fewer warps) measured slower (PERF.md).
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WALK_RAYS = 4;  // rays (warps) per block

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// Where a walk takes a slot's test from.  TriSlots: the triangle rows
// [p0 | e1 | e2 | pad] (A, B, D and F).  CoefSlots (E) is below, with its
// kernel.  enter_top runs once per walked top, before its children; closest
// is closest_terms of the slot (whether it is a valid hit, with its t and
// barycentrics); occludes (any hit) is occludes of the slot.
struct TriSlots {
  const float* __restrict__ tri;  // (B1*B2*K, 12)
  __device__ __forceinline__ void enter_top(int, const Ray&) {}
  __device__ __forceinline__ bool closest(size_t slot, const Ray& r, float limit, float& tt,
                                          float& b1, float& b2) const {
    return closest_terms(mt_terms4(tri + slot * 12, r), r.t_lo, limit, tt, b1, b2);
  }
  __device__ __forceinline__ bool occludes(size_t slot, const Ray& r) const {
    return ::occludes(mt_terms4(tri + slot * 12, r), r.t_lo, r.t_hi);
  }
};

// One chunk of closest hit merged into the batch bt: the sequential
// batch_test x K, with the slots spread over the warp.
template <class Slots>
__device__ __forceinline__ void warp_chunk_test(const Slots& rows, int node, int k, int lane,
                                                const Ray& r, Batch& bt) {
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    float tt = 0.0f, b1 = 0.0f, b2 = 0.0f;
    bool valid = false;
    if (s < k) valid = rows.closest((size_t)node * k + s, r, bt.limit, tt, b1, b2);
    const float mn = warp_min(valid ? tt : KINF);
    if (mn > bt.t) continue;  // every valid slot of the stride loses
    const unsigned tied = __ballot_sync(FULL_MASK, valid && tt == mn);
    if (tied == 0u) continue;  // no valid slot at all
    unsigned rest = tied;
    if (mn < bt.t) {  // the first tied slot replaces the state
      const int first = __ffs(tied) - 1;
      bt.t = __shfl_sync(FULL_MASK, tt, first);
      bt.b1 = __shfl_sync(FULL_MASK, b1, first);
      bt.b2 = __shfl_sync(FULL_MASK, b2, first);
      rest &= rest - 1u;
    }
    // slot ids only grow along a batch, so the max is the highest tied one
    bt.id = max(bt.id, node * k + s0 + 31 - __clz(tied));
    while (rest != 0u) {  // the others tie with it, in slot order
      const int l = __ffs(rest) - 1;
      rest &= rest - 1u;
      bt.b1 = fmaxf(bt.b1, __shfl_sync(FULL_MASK, b1, l));
      bt.b2 = fmaxf(bt.b2, __shfl_sync(FULL_MASK, b2, l));
    }
  }
}

// One chunk of any hit: whether a slot occludes in [t_lo, t_hi].
template <class Slots>
__device__ __forceinline__ bool warp_chunk_occludes(const Slots& rows, int node, int k, int lane,
                                                    const Ray& r) {
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    const bool occ = s < k && rows.occludes((size_t)node * k + s, r);
    if (__any_sync(FULL_MASK, occ)) return true;
  }
  return false;
}

// The walk's state, the same in every lane of the warp.
struct Walk {
  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;
  bool occluded = false;
};

// The children of top tp under the clip [t_lo, t_clip]: K tests charged per
// child box hit, then the hit chunks in ascending order, closest hit in
// batches of CB, a template argument so that at CB = 1 (every walk but A's
// on single-level trees) no batch state lives across chunks.
template <bool ANY_HIT, int CB, class Slots>
__device__ __forceinline__ void walk_top(const float* __restrict__ child, const Slots& rows, int tp,
                                         float t_clip, int b2, int k, int lane, const Ray& r,
                                         Walk& w) {
  Batch bt{};  // reset before its first use
  int in_batch = 0;
  for (int c0 = 0; c0 < b2; c0 += 32) {
    const int c = c0 + lane;
    const unsigned hits =
        __ballot_sync(FULL_MASK, c < b2 && box_hit4(child + 8 * (tp * b2 + c), r, r.t_lo, t_clip));
    w.tests += k * __popc(hits);  // the chunk mask is fixed for the whole top
    unsigned todo = (ANY_HIT && w.occluded) ? 0u : hits;
    while (todo != 0u) {
      const int node = tp * b2 + c0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      if constexpr (ANY_HIT) {
        if (warp_chunk_occludes(rows, node, k, lane, r)) {
          w.occluded = true;
          todo = 0u;
        }
      } else {
        if (in_batch == 0) batch_reset(bt, r.t_hi, w.best_t);
        warp_chunk_test(rows, node, k, lane, r, bt);
        if (++in_batch == CB) {
          batch_commit(bt, w.best_t, w.slot, w.ob1, w.ob2);
          in_batch = 0;
        }
      }
    }
  }
  if (!ANY_HIT && in_batch > 0) batch_commit(bt, w.best_t, w.slot, w.ob1, w.ob2);
}

// Steps 1-5 of the walk over the whole tree (A, B, D and E).
template <bool ANY_HIT, int CB, class Slots>
__device__ __forceinline__ void walk_tree(const float* __restrict__ top,
                                          const float* __restrict__ child, Slots& rows, int b1,
                                          int b2, int k, int lane, const Ray& r, Walk& w) {
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;
  if (!(r.finite && t_lo <= t_hi)) return;
  const float hi_pre = ANY_HIT ? fmaxf(t_hi, 0.0f) : t_hi;
  for (int tp0 = 0; tp0 < b1; tp0 += 32) {
    unsigned cand = 1u;  // a single-level tree has no top box to test
    if (b1 > 1) {
      const int tp = tp0 + lane;
      cand = __ballot_sync(FULL_MASK, tp < b1 && box_hit4(top + 8 * tp, r, t_lo, hi_pre));
    }
    while (cand != 0u) {
      const int tp = tp0 + __ffs(cand) - 1;
      cand &= cand - 1u;
      // once occluded, t_clip = 0: no box can be hit unless t_lo <= 0
      if (ANY_HIT && w.occluded && !(t_lo <= 0.0f)) return;
      const float t_clip = ANY_HIT ? (w.occluded ? 0.0f : t_hi) : min_nan(t_hi, w.best_t);
      if (b1 > 1 && t_clip != hi_pre && !box_hit4(top + 8 * tp, r, t_lo, t_clip)) continue;
      rows.enter_top(tp, r);
      walk_top<ANY_HIT, CB>(child, rows, tp, t_clip, b2, k, lane, r, w);
    }
  }
}

// The end of every warp walk: the any-hit marker, D's row (lanes 0-9, before
// the spheres), the sphere pass in every lane, and lane 0's outputs.
template <bool ANY_HIT, bool SHADE>
__device__ __forceinline__ void warp_finish(int i, int lane, const Ray& r, Walk& w,
                                            const float* __restrict__ shade,
                                            const float* __restrict__ sph, int n_spheres,
                                            int base_slot, float* __restrict__ out_t,
                                            int* __restrict__ out_slot,
                                            float* __restrict__ out_bary,
                                            int* __restrict__ out_tests,
                                            float* __restrict__ out_shade) {
  if (ANY_HIT && w.occluded) w.slot = 0;
  if (SHADE && lane < 10)  // lane j copies float j of the row
    out_shade[(size_t)10 * i + lane] = w.slot >= 0 ? shade[(size_t)10 * w.slot + lane] : 0.0f;
  sphere_pass(sph, n_spheres, base_slot, r, w.best_t, w.slot, w.tests);
  if (lane == 0) {
    out_t[i] = w.best_t;
    out_slot[i] = w.slot;
    out_bary[2 * i] = w.ob1;
    out_bary[2 * i + 1] = w.ob2;
    out_tests[i] = w.tests;
  }
}

template <bool ANY_HIT, bool SHADE, int CB>
__global__ void __launch_bounds__(32 * WALK_RAYS)
    warp_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                     const float* __restrict__ top, const float* __restrict__ child,
                     const float* __restrict__ tri, const float* __restrict__ shade,
                     const float* __restrict__ sph, int n, int b1, int b2, int k, int n_spheres,
                     float* __restrict__ out_t, int* __restrict__ out_slot,
                     float* __restrict__ out_bary, int* __restrict__ out_tests,
                     float* __restrict__ out_shade) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WALK_RAYS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
  Walk w;
  TriSlots rows{tri};
  walk_tree<ANY_HIT, CB>(top, child, rows, b1, b2, k, lane, r, w);
  warp_finish<ANY_HIT, SHADE>(i, lane, r, w, shade, sph, n_spheres, b1 * b2 * k, out_t, out_slot,
                              out_bary, out_tests, out_shade);
}

// The tile's padding lanes: o = d = 0, t_lo = t_hi = 0.
__device__ __forceinline__ Ray padding_ray() {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = 0.0f;
    r.d[a] = 0.0f;
    r.inv[a] = safe_inv(0.0f);
  }
  r.t_lo = r.t_hi = 0.0f;
  r.finite = true;
  return r;
}

// Kernel C: the tree-free pass over every real triangle of a tiny scene
// (row 4 of PERF.md's kernel table; row 5 with the closest-hit flag).  Rays
// are grouped in 1024-lane tiles as the TPU kernel's grid was: a tile with
// no live lane (t_hi > t_lo) does no work at all, sphere tests included.
//
// What bounds it is operations: every lane of a live tile takes s_real <=
// 512 Moller-Trumbore tests of ~60 instructions each (no fused multiply-add
// under --fmad=false), and its inputs are a few KB.  So:
// - A block stages the scene's s_real rows in shared memory once (<= 24 KB
//   of 48-byte rows), with coalesced float4 loads by all its threads: the
//   rows are contiguous and one L2 round trip each, so a bulk copy with an
//   mbarrier would buy nothing here.  Every read of a row is then a
//   warp-wide broadcast of three float4.
// - One ray per thread, BRUTE_LANES of them per block inside one tile, so
//   that the main path's 64k lanes give 256 blocks of 8 warps for 132 SMs
//   (64 tiles would leave half the SMs idle).  Two or four rays per thread,
//   each row read feeding that many tests, measured slower, as did
//   reordering a block's lanes so that dead lanes take a cheaper test: the
//   issue rate of the tests is what bounds the pass (PERF.md).
// - A block learns whether its tile is live from its own lanes, and reads
//   the tile's other lanes, once each, only where its own are all dead.
// - Any hit: a warp stops once each of its lanes is occluded or cannot be
//   (a NaN in the ray fails every comparison).  A lane with an empty
//   interval (t_lo > t_hi) keeps testing: the divide-free test accepts it
//   where t_lo * |det| and t_hi * |det| round alike.  tests is s_real per
//   live lane whatever the exit.
// - Closest hit: the rows in static blocks of 64, batch_reset / batch_test
//   / batch_commit per block as the TPU kernel's sublane blocks resolved
//   them (ties to the highest slot within a block, the earliest block
//   across blocks).
constexpr int BRUTE_LANES = 256;  // lanes per block, one per thread
static_assert(BRUTE_TILE % BRUTE_LANES == 0, "a block must lie inside one brute tile");

template <bool CLOSEST>
__global__ void __launch_bounds__(BRUTE_LANES)
    brute_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                 const float* __restrict__ tri, const float* __restrict__ sph, int n, int s_real,
                 int s_pad, int n_spheres, float* __restrict__ out_t, int* __restrict__ out_slot,
                 float* __restrict__ out_bary, int* __restrict__ out_tests) {
  __shared__ float4 rows[3 * BRUTE_MAX_TRIS];  // row s: rows[3s .. 3s+2]
  const float4* tri4 = reinterpret_cast<const float4*>(tri);
  for (int j = threadIdx.x; j < 3 * s_real; j += BRUTE_LANES) rows[j] = __ldg(tri4 + j);

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * BRUTE_LANES;
  const int i = lane0 + tid;
  const Ray r = i < n ? load_ray(o, d, t_lo_in, t_hi_in, i) : padding_ray();
  bool live = __syncthreads_or(r.t_hi > r.t_lo) != 0;  // also publishes the rows
  if (!live) {
    const int tile0 = lane0 - lane0 % BRUTE_TILE;
    const int tile1 = min(tile0 + BRUTE_TILE, n);
    int other = 0;
    for (int l = tile0 + tid; l < tile1; l += BRUTE_LANES)
      if (l < lane0 || l >= lane0 + BRUTE_LANES) other |= (t_hi_in[l] > t_lo_in[l]) ? 1 : 0;
    live = __syncthreads_or(other) != 0;
  }

  float best_t = KINF, ob1 = 0.0f, ob2 = 0.0f;
  int slot = -1, tests = 0;
  if (live) {  // block-uniform
    if (CLOSEST) {
      for (int c0 = 0; c0 < s_real; c0 += BRUTE_BLOCK) {
        Batch bt;
        batch_reset(bt, r.t_hi, best_t);
        const int c1 = min(c0 + BRUTE_BLOCK, s_real);
        for (int s = c0; s < c1; ++s) {
          const float4 a = rows[3 * s], b = rows[3 * s + 1], c = rows[3 * s + 2];
          const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
          batch_test(bt, mt_terms(v, r), s, r.t_lo);
        }
        batch_commit(bt, best_t, slot, ob1, ob2);
      }
    } else {
      bool occ = false;
      const bool never = i >= n || !r.finite;
      for (int s = 0; s < s_real; ++s) {
        if (__all_sync(FULL_MASK, occ || never)) break;  // warp-uniform
        const float4 a = rows[3 * s], b = rows[3 * s + 1], c = rows[3 * s + 2];
        const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
        occ = occludes(mt_terms(v, r), r.t_lo, r.t_hi) || occ;
      }
      if (occ) slot = 0;
    }
    tests = (r.t_hi > r.t_lo) ? s_real : 0;
    sphere_pass(sph, n_spheres, s_pad, r, best_t, slot, tests);
  }
  if (i >= n) return;
  out_t[i] = best_t;
  out_slot[i] = slot;
  out_bary[2 * i] = ob1;
  out_bary[2 * i + 1] = ob2;
  out_tests[i] = tests;
}

// Kernel E: the coefficient walk (row 7 of PERF.md's kernel table).
//
// With the features f = [1 | o-c | d | g = d x (o-c)] of a ray about its
// top's centre c, the Moller-Trumbore numerators det, t.det, b1.det and
// b2.det are linear forms per slot.  The TPU kernel evaluated them as one
// (16,128)^T x (16,TILE) matrix product per chunk on its matrix unit, since
// its vector unit is narrow.  Here E is A's warp-per-ray walk at chunk batch
// 1 (walk_tree) with another slot test, CoefSlots: every lane forms f once
// per walked top, with mxu_fmat's rounding (intersect_pallas.py:310-332: two
// products, then their difference), and lane s of a chunk reads its slot's
// packed row, the ten non-zero coefficients of each of the four forms (160
// bytes, ten float4, coalesced across the chunk's 32 slots), and takes the
// four 10-term dot products in order 0 -> 9 in plain float32, reading the
// t and b2 forms only for slots whose det and b1 pass (CoefSlots::closest).
// The warp then reduces the chunk as A does.  What bounds it is A's latency
// chain, with up to 160 bytes and 76 FLOP per slot test where A has 48 and
// 41; the two-stage read took the primary rows' time down 9-12% and the
// bounce rows' up 7-9% (PERF.md).  The tensor cores do not serve this
// walk: one ray against a chunk is a (128 x 10) by (10 x 1) product, 1/8 of
// the smallest mma.sync tile; float32 accuracy needs the 3xTF32 split,
// which triples the work and gives up bit equality with the plain version;
// and a packet of rays sharing each chunk, as the TPU tile did, walks the
// union of the packet's chunks, the divergence the warp walk removed.
__device__ __forceinline__ float dot10(const float* q, const float* f) {
  float acc = q[0] * f[0];
#pragma unroll
  for (int j = 1; j < MXU_FEATURES; ++j) acc = acc + q[j] * f[j];
  return acc;
}

struct CoefSlots {
  const float* __restrict__ coef;     // (B1*B2*K, 40) [det | t.det | b1.det | b2.det] x 10
  const float* __restrict__ centers;  // (B1, 3)
  float f[MXU_FEATURES];              // the ray's features about the walked top's centre

  __device__ __forceinline__ void enter_top(int tp, const Ray& r) {
    const float ocx = r.o[0] - centers[3 * tp];
    const float ocy = r.o[1] - centers[3 * tp + 1];
    const float ocz = r.o[2] - centers[3 * tp + 2];
    f[0] = 1.0f;
    f[1] = ocx;
    f[2] = ocy;
    f[3] = ocz;
    f[4] = r.d[0];
    f[5] = r.d[1];
    f[6] = r.d[2];
    f[7] = r.d[1] * ocz - r.d[2] * ocy;
    f[8] = r.d[2] * ocx - r.d[0] * ocz;
    f[9] = r.d[0] * ocy - r.d[1] * ocx;
  }

  // closest_terms in two reads: det and b1.det (float4 0-2 and 5-7 of the
  // row), then, only where det != 0 and b1 lies in [0, 1], t.det and b2.det
  // (float4 3-4 and 8-9).  A slot that fails the first half is invalid
  // whatever the rest, and an invalid slot's t and barycentrics are never
  // read, so this is closest_terms' result with fewer bytes.
  __device__ __forceinline__ bool closest(size_t slot, const Ray& r, float limit, float& tt,
                                          float& b1, float& b2) const {
    const float4* q4 = reinterpret_cast<const float4*>(coef + slot * (4 * MXU_FEATURES));
    float q[4 * MXU_FEATURES];
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // float4 0-2 and 5-7
      load4(q, q4, j);
      load4(q, q4, j + 5);
    }
    const float det = dot10(q, f);
    const float inv_det = 1.0f / (det == 0.0f ? 1e-30f : det);
    b1 = dot10(q + 2 * MXU_FEATURES, f) * inv_det;
    if (!((det != 0.0f) && (b1 >= 0.0f) && (b1 <= 1.0f))) return false;
#pragma unroll
    for (int j = 3; j < 5; ++j) {  // float4 3-4 and 8-9
      load4(q, q4, j);
      load4(q, q4, j + 5);
    }
    tt = dot10(q + MXU_FEATURES, f) * inv_det;
    b2 = dot10(q + 3 * MXU_FEATURES, f) * inv_det;
    return (tt >= r.t_lo) && (tt <= limit) && (b2 >= 0.0f) && (b2 <= 1.0f) && (b1 + b2 <= 1.0f);
  }

  static __device__ __forceinline__ void load4(float* q, const float4* q4, int j) {
    const float4 v = __ldg(q4 + j);
    q[4 * j] = v.x;
    q[4 * j + 1] = v.y;
    q[4 * j + 2] = v.z;
    q[4 * j + 3] = v.w;
  }
};

__global__ void __launch_bounds__(32 * WALK_RAYS)
    mxu_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                    const float* __restrict__ top, const float* __restrict__ child,
                    const float* __restrict__ coef, const float* __restrict__ centers,
                    const float* __restrict__ sph, int n, int b1, int b2, int k, int n_spheres,
                    float* __restrict__ out_t, int* __restrict__ out_slot,
                    float* __restrict__ out_bary, int* __restrict__ out_tests) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WALK_RAYS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
  Walk w;
  CoefSlots rows{coef, centers, {}};
  walk_tree<false, 1>(top, child, rows, b1, b2, k, lane, r, w);
  warp_finish<false, false>(i, lane, r, w, nullptr, sph, n_spheres, b1 * b2 * k, out_t, out_slot,
                            out_bary, out_tests, nullptr);
}

// Kernel F: the top-batched group walk (row 8), closest hit (ANY_HIT and
// SHADE false), any hit (ANY_HIT) and closest hit with D's shading rows
// (SHADE).  Its t, slot, barycentrics, hits and rows equal A's, B's and D's;
// it differs from them in when the clip interval is fixed, which shows only
// in the tests counter.  To count as the TPU kernel did, lane for lane, rays
// go in tiles of the TPU grid, of the size the caller passes
// (intersect_cuda.group_tile: _auto_tile's 512 lanes, or 1024 for any hit),
// tail padding lanes included (o = d = 0, t_lo = t_hi = 0,
// intersect_pallas.py:1435-1440).  A lane's walk depends on its tile through
// the tile's active-top list and, for any hit, the group before which the
// tile stops.  Each is computed in a pass of its own, so that the walk keeps
// one warp per ray (A's, B's and D's design) rather than one block per tile:
// 1. group_list_kernel, one block per tile, one thread per lane up to 1024:
//    the tile's lanes OR their top-box hits under [t_lo, t_hi] into a
//    shared flag per top (intersect_pallas.py:342-347), and one warp
//    compacts the flags into the tile's ascending active-top list, written
//    to global scratch with its length.
// 2. group_walk_kernel, one warp per ray: the lane walks its tile's list in
//    groups of TB tops (group_walk).  The clip is fixed at the group's start
//    (min(t_hi, best_t); [t_lo, 0] once occluded), K tests are charged per
//    child box hit under it, and the chunks resolve in group order (tops in
//    list order, children ascending) with the running best as each chunk's
//    limit (group_body, :699-799).  The list goes in words of 32 entries, a
//    ballot of their top boxes under the loosest clip first, as in A's walk.
//    Any hit: the tile stops before the first group at which every lane is
//    occluded or dead (t_hi <= t_lo), the while_loop of :803-816.  A lane is
//    so from its "done group" on: 0 if dead, one past the group in which it
//    became occluded, else the tile's group count (a NaN lane, for one).  The
//    lane walks up to its done group, and atomicMax folds that into its
//    tile's exit group.
// 3. Any hit only, group_continue_kernel: the lanes that are charged after
//    they are done walk on from their done group to the tile's exit group:
//    occluded lanes with t_lo <= 0, which still enter boxes under [t_lo, 0],
//    and dead lanes with t_lo == t_hi, which enter boxes at a point (their
//    whole walk).  A warp takes 32 lanes and walks those few in turn.
// The children of a top lie inside its box and the slab test is monotone in
// the box bounds, so a lane that misses a top's box under the clip misses all
// its children: skipping them changes no count.  What bounds it is the walk
// pass, latency-bound as A's walk; the list pass (tile x B1 box tests per
// tile) is about an eighth of a call at the kernel bench's shapes (PERF.md).
constexpr int LIST_MAX_THREADS = 1024;

__global__ void __launch_bounds__(LIST_MAX_THREADS)
    group_list_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                      const float* __restrict__ top, int n, int b1, int tile,
                      int* __restrict__ lists, int* __restrict__ counts,
                      int* __restrict__ exits) {
  extern __shared__ int flags[];  // (b1,) 1 where a lane of the tile hits the top
  const int t = blockIdx.x;
  for (int j = threadIdx.x; j < b1; j += blockDim.x) flags[j] = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < tile; l += blockDim.x) {
    const int i = t * tile + l;
    const Ray r = i < n ? load_ray(o, d, t_lo_in, t_hi_in, i) : padding_ray();
    if (!r.finite) continue;
    // a flag another lane has set needs no test (a stale read only costs one)
    for (int tp = 0; tp < b1; ++tp)
      if (!flags[tp] && box_hit4(top + 8 * tp, r, r.t_lo, r.t_hi)) flags[tp] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < b1; base += 32) {
      const int j = base + lane;
      const bool f = j < b1 && flags[j] != 0;
      const unsigned mask = __ballot_sync(FULL_MASK, f);
      if (f) lists[(size_t)t * b1 + count + __popc(mask & ((1u << lane) - 1u))] = j;
      count += __popc(mask);
    }
    if (lane == 0) {
      counts[t] = count;
      exits[t] = 0;
    }
  }
}

// Entries [e_begin, e_end) of the tile's list, in groups of tb from entry 0.
// stop_when_done (pass 2 of any hit): stop at the lane's done group.
// Returns the group in which the lane became occluded (any hit), else -1.
template <bool ANY_HIT>
__device__ __forceinline__ int group_walk(const float* __restrict__ top,
                                          const float* __restrict__ child,
                                          const float* __restrict__ tri,
                                          const int* __restrict__ list, int e_begin, int e_end,
                                          int tb, bool stop_when_done, int b2, int k, int lane,
                                          const Ray& r, Walk& w) {
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;
  const float hi_pre = ANY_HIT ? fmaxf(t_hi, 0.0f) : t_hi;
  int occ_group = -1;
  int g_cur = -1;
  float t_clip = t_hi;
  for (int j0 = e_begin & ~31; j0 < e_end; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j >= e_begin && j < e_end;
    const int tp_l = in ? list[j] : 0;
    unsigned cand = __ballot_sync(FULL_MASK, in && box_hit4(top + 8 * tp_l, r, t_lo, hi_pre));
    while (cand != 0u) {
      const int bit = __ffs(cand) - 1;
      cand &= cand - 1u;
      const int g = (j0 + bit) / tb;
      if (g != g_cur) {
        // a group with no candidate changes nothing, so the clip taken at
        // its first candidate is the one fixed at its start
        if (ANY_HIT && w.occluded && (stop_when_done || !(t_lo <= 0.0f))) return occ_group;
        g_cur = g;
        t_clip = ANY_HIT ? (w.occluded ? 0.0f : t_hi) : min_nan(t_hi, w.best_t);
      }
      const int tp = __shfl_sync(FULL_MASK, tp_l, bit);
      if (t_clip != hi_pre && !box_hit4(top + 8 * tp, r, t_lo, t_clip)) continue;
      const bool was_occluded = w.occluded;
      walk_top<ANY_HIT, 1>(child, TriSlots{tri}, tp, t_clip, b2, k, lane, r, w);
      if (ANY_HIT && w.occluded && !was_occluded) occ_group = g;
    }
  }
  return occ_group;
}

template <bool ANY_HIT, bool SHADE>
__global__ void __launch_bounds__(32 * WALK_RAYS)
    group_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                      const float* __restrict__ top, const float* __restrict__ child,
                      const float* __restrict__ tri, const float* __restrict__ shade,
                      const float* __restrict__ sph, int n, int b1, int b2, int k,
                      int n_spheres, int tb, int tile, const int* __restrict__ lists,
                      const int* __restrict__ counts, int* __restrict__ exits,
                      int* __restrict__ cont, float* __restrict__ out_t,
                      int* __restrict__ out_slot, float* __restrict__ out_bary,
                      int* __restrict__ out_tests, float* __restrict__ out_shade) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WALK_RAYS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;
  const int t = i / tile;
  const int n_top = counts[t];
  Walk w;
  // any hit: a dead lane (t_hi <= t_lo) is done from group 0, so its walk,
  // where it has one (t_lo == t_hi), is pass 3's
  const bool walks = r.finite && (ANY_HIT ? t_lo < t_hi : t_lo <= t_hi);
  int occ_group = -1;
  if (walks)
    occ_group = group_walk<ANY_HIT>(top, child, tri, lists + (size_t)t * b1, 0, n_top, tb, ANY_HIT,
                                    b2, k, lane, r, w);
  if (ANY_HIT) {
    const int n_groups = (n_top + tb - 1) / tb;
    const int done = (t_hi <= t_lo) ? 0 : (w.occluded ? occ_group + 1 : n_groups);
    const bool charged_on = r.finite && ((w.occluded && t_lo <= 0.0f) || t_lo == t_hi);
    if (lane == 0) {
      atomicMax(exits + t, done);
      cont[i] = charged_on ? done : -1;
    }
  }
  warp_finish<ANY_HIT, SHADE>(i, lane, r, w, shade, sph, n_spheres, b1 * b2 * k, out_t, out_slot,
                              out_bary, out_tests, out_shade);
}

__global__ void __launch_bounds__(32 * WALK_RAYS)
    group_continue_kernel(const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                          const float* __restrict__ top, const float* __restrict__ child,
                          const float* __restrict__ tri, int n, int b1, int b2, int k, int tb,
                          int tile, const int* __restrict__ lists,
                          const int* __restrict__ counts, const int* __restrict__ exits,
                          const int* __restrict__ cont, int* __restrict__ out_slot,
                          int* __restrict__ out_tests) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * WALK_RAYS + (threadIdx.x >> 5)) * 32;
  if (base >= n) return;  // the whole warp
  const int j = base + lane;
  const int from = j < n ? cont[j] : -1;
  const int to = j < n ? exits[j / tile] : 0;
  unsigned todo = __ballot_sync(FULL_MASK, from >= 0 && from < to);
  while (todo != 0u) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int i = base + l;
    const int g0 = __shfl_sync(FULL_MASK, from, l);
    const int g1 = __shfl_sync(FULL_MASK, to, l);
    const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
    const int t = i / tile;
    Walk w;
    w.occluded = r.t_lo != r.t_hi;  // an occluded lane; a dead one walks afresh
    group_walk<true>(top, child, tri, lists + (size_t)t * b1, g0 * tb, min(counts[t], g1 * tb),
                     tb, false, b2, k, lane, r, w);
    if (lane == 0) {
      out_tests[i] += w.tests;
      // pass 2 wrote -1 where neither a triangle nor a sphere was hit
      if (w.occluded && out_slot[i] == -1) out_slot[i] = 0;
    }
  }
}

template <bool ANY_HIT, bool SHADE, int CB>
int launch_walk(const float* o, const float* d, const float* t_lo, const float* t_hi,
                const float* top, const float* child, const float* tri, const float* shade,
                const float* sph, int n, int b1, int b2, int k, int n_spheres, float* out_t,
                int* out_slot, float* out_bary, int* out_tests, float* out_shade, void* stream) {
  if (b1 < 1 || b2 < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + WALK_RAYS - 1) / WALK_RAYS;
    warp_walk_kernel<ANY_HIT, SHADE, CB><<<grid, 32 * WALK_RAYS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, tri, shade, sph, n, b1, b2, k, n_spheres, out_t, out_slot,
        out_bary, out_tests, out_shade);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// rays are o (N, 3), d (N, 3), t_lo (N,), t_hi (N,); outputs t (N,),
// slot (N,), bary (N, 2), tests (N,).  Returns cudaGetLastError().
// Kernels A, B, D, E and F walk one ray per warp: top, child and tri 16-byte
// aligned (the wrapper checks), any B1, B2, K >= 1.
// Kernel A: chunk_batch 1 or 2 (_auto_chunk_batch: 2 on single-level trees).
extern "C" int lf_tree_closest(const float* o, const float* d, const float* t_lo,
                               const float* t_hi, const float* top, const float* child,
                               const float* tri, const float* sph, int n, int b1, int b2, int k,
                               int n_spheres, int chunk_batch, float* out_t, int* out_slot,
                               float* out_bary, int* out_tests, void* stream) {
  if (chunk_batch == 1)
    return launch_walk<false, false, 1>(o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1,
                                        b2, k, n_spheres, out_t, out_slot, out_bary, out_tests,
                                        nullptr, stream);
  if (chunk_batch == 2)
    return launch_walk<false, false, 2>(o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1,
                                        b2, k, n_spheres, out_t, out_slot, out_bary, out_tests,
                                        nullptr, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel D: shade (B1*B2*K, 10) slot-ordered [9 corner-normal components |
// bsdf id]; out_shade (N, 10).  Chunk batch 1, as the TPU's shade mode forces
// (intersect_pallas.py:1307-1308).
extern "C" int lf_tree_closest_shade(const float* o, const float* d, const float* t_lo,
                                     const float* t_hi, const float* top, const float* child,
                                     const float* tri, const float* shade, const float* sph,
                                     int n, int b1, int b2, int k, int n_spheres, float* out_t,
                                     int* out_slot, float* out_bary, int* out_tests,
                                     float* out_shade, void* stream) {
  return launch_walk<false, true, 1>(o, d, t_lo, t_hi, top, child, tri, shade, sph, n, b1, b2, k,
                                     n_spheres, out_t, out_slot, out_bary, out_tests, out_shade,
                                     stream);
}

extern "C" int lf_tree_any_hit(const float* o, const float* d, const float* t_lo,
                               const float* t_hi, const float* top, const float* child,
                               const float* tri, const float* sph, int n, int b1, int b2, int k,
                               int n_spheres, float* out_t, int* out_slot, float* out_bary,
                               int* out_tests, void* stream) {
  return launch_walk<true, false, 1>(o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k,
                                     n_spheres, out_t, out_slot, out_bary, out_tests, nullptr,
                                     stream);
}

// Kernel C: tri (s_pad, 12) rows [p0 | e1 | e2 | pad], 16-byte aligned,
// s_real <= 512 of them real (the wrapper checks).
extern "C" int lf_brute(const float* o, const float* d, const float* t_lo, const float* t_hi,
                        const float* tri, const float* sph, int n, int s_real, int s_pad,
                        int n_spheres, int closest, float* out_t, int* out_slot, float* out_bary,
                        int* out_tests, void* stream) {
  if (s_real < 0 || s_real > BRUTE_MAX_TRIS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + BRUTE_LANES - 1) / BRUTE_LANES;
    if (closest)
      brute_kernel<true><<<grid, BRUTE_LANES, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, tri, sph, n, s_real, s_pad, n_spheres, out_t, out_slot, out_bary,
          out_tests);
    else
      brute_kernel<false><<<grid, BRUTE_LANES, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, tri, sph, n, s_real, s_pad, n_spheres, out_t, out_slot, out_bary,
          out_tests);
  }
  return (int)cudaGetLastError();
}

// Kernel E: coef (B1*B2*K, 40) packed rows, the ten non-zero columns of each
// of the four forms of intersect_cuda.mxu_tables; centers (B1, 3).  One ray
// per warp: top, child and coef 16-byte aligned (the wrapper checks).
extern "C" int lf_tree_closest_mxu(const float* o, const float* d, const float* t_lo,
                                   const float* t_hi, const float* top, const float* child,
                                   const float* coef, const float* centers, const float* sph,
                                   int n, int b1, int b2, int k, int n_spheres, float* out_t,
                                   int* out_slot, float* out_bary, int* out_tests, void* stream) {
  if (b1 < 1 || b2 < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + WALK_RAYS - 1) / WALK_RAYS;
    mxu_walk_kernel<<<grid, 32 * WALK_RAYS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, coef, centers, sph, n, b1, b2, k, n_spheres, out_t, out_slot,
        out_bary, out_tests);
  }
  return (int)cudaGetLastError();
}

// Kernel F: tb tops per group (2 <= tb <= b1, multi-level trees) in tiles
// of tile lanes; any_hit selects the any-hit instance, shade_rows the shade
// one (shade and out_shade as for kernel D).  Two passes, three for any hit
// (see group_walk_kernel).  The tiles' lists, counts and exit groups, and
// for any hit one int per lane, live in scratch taken from the stream's
// pool (cudaMallocAsync) and given back on the same stream after the last
// pass: no host synchronisation, and the C interface is the one the
// single-pass kernel had.
extern "C" int lf_tree_group(const float* o, const float* d, const float* t_lo,
                             const float* t_hi, const float* top, const float* child,
                             const float* tri, const float* shade, const float* sph, int n,
                             int b1, int b2, int k, int n_spheres, int tb, int tile,
                             int any_hit, int shade_rows, float* out_t, int* out_slot,
                             float* out_bary, int* out_tests, float* out_shade, void* stream) {
  if (b1 < 1 || b2 < 1 || k < 1 || tb < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n - 1) / tile + 1;
  const size_t words = (size_t)n_tiles * (b1 + 2) + (any_hit ? (size_t)n : 0);
  int* scratch = nullptr;
  cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&scratch), words * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int* lists = scratch;                       // (n_tiles, b1)
  int* counts = lists + (size_t)n_tiles * b1;  // (n_tiles,)
  int* exits = counts + n_tiles;               // (n_tiles,)
  int* cont = exits + n_tiles;                 // (n,), any hit
  const int list_threads = tile < LIST_MAX_THREADS ? (tile + 31) / 32 * 32 : LIST_MAX_THREADS;
  group_list_kernel<<<n_tiles, list_threads, sizeof(int) * (size_t)b1, st>>>(
      o, d, t_lo, t_hi, top, n, b1, tile, lists, counts, exits);
  const int grid = (n + WALK_RAYS - 1) / WALK_RAYS;
  if (any_hit) {
    group_walk_kernel<true, false><<<grid, 32 * WALK_RAYS, 0, st>>>(
        o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k, n_spheres, tb, tile, lists,
        counts, exits, cont, out_t, out_slot, out_bary, out_tests, nullptr);
    const int grid_cont = (n + 32 * WALK_RAYS - 1) / (32 * WALK_RAYS);
    group_continue_kernel<<<grid_cont, 32 * WALK_RAYS, 0, st>>>(
        o, d, t_lo, t_hi, top, child, tri, n, b1, b2, k, tb, tile, lists, counts, exits, cont,
        out_slot, out_tests);
  } else if (shade_rows) {
    group_walk_kernel<false, true><<<grid, 32 * WALK_RAYS, 0, st>>>(
        o, d, t_lo, t_hi, top, child, tri, shade, sph, n, b1, b2, k, n_spheres, tb, tile, lists,
        counts, exits, nullptr, out_t, out_slot, out_bary, out_tests, out_shade);
  } else {
    group_walk_kernel<false, false><<<grid, 32 * WALK_RAYS, 0, st>>>(
        o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k, n_spheres, tb, tile, lists,
        counts, exits, nullptr, out_t, out_slot, out_bary, out_tests, nullptr);
  }
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(scratch, st);
  return (int)(err != cudaSuccess ? err : freed);
}

// ---------------------------------------------------------------------------
// Kernel G: the binary-BVH walk (lens_flare_tpu/ops/intersect.py:152-259)
// ---------------------------------------------------------------------------
//
// Replaces the JAX package's XLA walk, _make_traverse (ops/intersect.py:152),
// which the port takes past the cluster tree's capacity.  The tree is
// accel/bvh.py's FlatBVH as ops/intersect.py:bvh_to_device packs it:
// - root (8,) [min.xyz | max.xyz | link | 0]: the root's box, for the first
//   slab test, and its link;
// - nodes (R, 16): one 64-byte record per interior node, in the tree's
//   depth-first order: [left min.xyz | left max.xyz | right min.xyz |
//   right max.xyz | left link | right link | left id | right id];
// - rows (P, 12): one 48-byte row per primitive in leaf (prim_order) order,
//   triangles [p0 | e1 | e2 | id], spheres [center | radius | 0 x 7 | id].
// A link is a record index (>= 0) for an interior child, or
// ~(start << 3 | count) for a leaf, its range of rows; a missing child
// (only the empty tree's root lacks children) has NaN bounds, which fail
// every slab test.  The node ids serve the plain version's visit counts.
//
// What bounds it: latency.  The least bytes the walk must move
// (bench_kernels.bvh_bound) take 2-3% of the one-thread-per-ray walk's
// time: each ray runs a chain of dependent loads, most of them from HBM
// past ~1M triangles (the 16.8M-triangle tree is 314 MB of records).  The
// design shortens the chain and keeps the SMs full:
// - one round trip per interior step: a record's four 16-byte loads go out
//   together and hold both children's boxes and links, so a leaf child's
//   range comes with its parent and costs no fetch of its own (the links
//   and the boxes were two dependent trips);
// - a leaf's up to 4 rows are contiguous and all their loads go out before
//   the first test (their addresses do not depend on best_t, only the clip
//   does); no prim_order load stands before a row's;
// - the stack lives in shared memory, 64 entries x 128 threads = 32 KB a
//   block, entry k of thread i at [k * 128 + i] (one bank per lane), not in
//   local memory;
// - while-while scheduling (Aila and Laine, "Understanding the Efficiency
//   of Ray Traversal on GPUs", HPG 2009): each lane steps through interior
//   records until it holds a leaf or is done, then the warp tests its
//   leaves; persistent warps, as many as fit on the card, take 32 rays at
//   a time from a global counter, so no warp idles while rays remain.  No
//   speculative traversal: it would test child boxes under another clip.
// Per ray, every box and primitive test comes in the plain version's order
// (ops/intersect_cuda.py:bvh_walk_plain), so the outputs are its bit for bit:
// - a leaf tests its up to 4 primitives in order, each against
//   [t_lo, min(t_hi, best_t)], the winner on strictly smaller t, and each
//   counts as a test (spheres too); any hit stops after the leaf that hit;
// - an interior node slab-tests both children under the same clip; the near
//   one (the smaller entry t, left on ties) is walked next and the far one
//   pushed, as the XLA walk pushes far then near and pops near;
// - Moller-Trumbore multiplies by the reciprocal of det (0 where det == 0),
//   the sphere quadratic divides by 2a; misses keep t = 1e30, prim = -1.
// A ray with a NaN among o, d, t_lo, t_hi misses the root, as the plain
// version's NaN-propagating min/max make it.

#define BVH_INF 1e30f
#define BVH_MAX_LEAF 4
#define BVH_MAX_STACK 64
#define BVH_THREADS 128
#define BVH_LEAF_BITS 3
#define BVH_DONE (-2147483647 - 1)  // no node: never a link (start < 2^28, count <= 4)

namespace {

// _ray_box (ops/intersect.py:102) for the box [mn0..2] x [mx0..2].
__device__ __forceinline__ bool bvh_box(float mn0, float mn1, float mn2, float mx0, float mx1, float mx2,
                                        const Ray& r, float t_lo, float t_hi, float& t_entry) {
  const float mn[3] = {mn0, mn1, mn2};
  const float mx[3] = {mx0, mx1, mx2};
  float t_min = 0.0f, t_max = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (mn[a] - r.o[a]) * r.inv[a];
    const float t2 = (mx[a] - r.o[a]) * r.inv[a];
    const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
    t_min = a == 0 ? lo : fmaxf(t_min, lo);
    t_max = a == 0 ? hi : fminf(t_max, hi);
  }
  t_entry = t_min;
  return (t_min <= t_max) && (t_max >= t_lo) && (t_min <= t_hi);
}

// Moller-Trumbore on a row [p0 | e1 | e2 | id] held in three float4.
__device__ __forceinline__ bool bvh_triangle(const float4 (&q)[3], const Ray& r, float limit, float& t,
                                             float& b1, float& b2) {
  const float v[9] = {q[0].x, q[0].y, q[0].z, q[0].w, q[1].x, q[1].y, q[1].z, q[1].w, q[2].x};
  const MT m = mt_terms(v, r);
  const float inv_det = m.det != 0.0f ? 1.0f / m.det : 0.0f;
  t = m.tt_n * inv_det;
  b1 = m.bb1_n * inv_det;
  b2 = m.bb2_n * inv_det;
  return (m.det != 0.0f) && (t >= r.t_lo) && (t <= limit) && (b1 >= 0.0f) && (b1 <= 1.0f) &&
         (b2 >= 0.0f) && (b2 <= 1.0f) && (b1 + b2 <= 1.0f);
}

// The sphere quadratic on a row's first float4 [center | radius].
__device__ __forceinline__ bool bvh_sphere(const float4 c, const Ray& r, float limit, float& t) {
  const float ocx = r.o[0] - c.x, ocy = r.o[1] - c.y, ocz = r.o[2] - c.z;
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w * c.w;
  const float disc = b * b - 4.0f * a * cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-b - sq) / (2.0f * a);
  const float t2 = (-b + sq) / (2.0f * a);
  const bool t1_ok = (t1 >= r.t_lo) && (t1 <= limit);
  const bool t2_ok = (t2 >= r.t_lo) && (t2 <= limit);
  t = t1_ok ? t1 : t2;
  return (disc >= 0.0f) && (t1_ok || t2_ok);
}

struct BvhHit {
  float t = BVH_INF, b1 = 0.0f, b2 = 0.0f;
  int prim = -1, tests = 0;
  bool found = false;
};

// One ray's walk; stack is this thread's column of the block's shared stack.
template <bool ANY_HIT>
__device__ __forceinline__ BvhHit bvh_walk_ray(const Ray& r, float4 root0, float4 root1,
                                               const float4* __restrict__ nodes,
                                               const float4* __restrict__ rows, int num_tris,
                                               int* stack) {
  BvhHit h;
  int cur = BVH_DONE, sp = 0;
  float t_entry;
  if (r.finite && bvh_box(root0.x, root0.y, root0.z, root0.w, root1.x, root1.y, r, r.t_lo, r.t_hi,
                          t_entry))
    cur = __float_as_int(root1.z);
  while (cur != BVH_DONE) {
    // interior records until this lane holds a leaf or is done
    while (cur >= 0) {
      const float4* rec = nodes + 4 * (size_t)cur;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
      const int2 link = __ldg(reinterpret_cast<const int2*>(rec + 3));
      const float limit = fminf(r.t_hi, h.t);
      float l_t, r_t;
      const bool l_ok = bvh_box(a.x, a.y, a.z, a.w, b.x, b.y, r, r.t_lo, limit, l_t);
      const bool r_ok = bvh_box(b.z, b.w, c.x, c.y, c.z, c.w, r, r.t_lo, limit, r_t);
      const bool near_left = l_t <= r_t;
      const int far = near_left ? link.y : link.x, near = near_left ? link.x : link.y;
      const bool far_ok = near_left ? r_ok : l_ok, near_ok = near_left ? l_ok : r_ok;
      if (near_ok) {
        if (far_ok && sp < BVH_MAX_STACK) stack[BVH_THREADS * sp++] = far;
        cur = near;
      } else if (far_ok) {
        cur = far;
      } else {
        cur = sp > 0 ? stack[BVH_THREADS * --sp] : BVH_DONE;
      }
    }
    if (cur == BVH_DONE) break;
    // a leaf: every row's loads first, then the tests in order
    const int range = ~cur;
    const int first = range >> BVH_LEAF_BITS, count = range & ((1 << BVH_LEAF_BITS) - 1);
    float4 q[BVH_MAX_LEAF][3];
#pragma unroll
    for (int s = 0; s < BVH_MAX_LEAF; ++s) {
      if (s < count) {
#pragma unroll
        for (int k = 0; k < 3; ++k) q[s][k] = __ldg(rows + 3 * ((size_t)first + s) + k);
      }
    }
#pragma unroll
    for (int s = 0; s < BVH_MAX_LEAF; ++s) {
      if (s < count) {
        const int p = __float_as_int(q[s][2].w);
        const float limit = fminf(r.t_hi, h.t);
        const bool is_tri = p < num_tris;
        float t, b1 = 0.0f, b2 = 0.0f;
        const bool valid = is_tri ? bvh_triangle(q[s], r, limit, t, b1, b2)
                                  : bvh_sphere(q[s][0], r, limit, t);
        ++h.tests;
        if (valid && t < h.t) {
          h.t = t;
          h.prim = p;
          if (is_tri) {
            h.b1 = b1;
            h.b2 = b2;
          }
        }
        h.found = h.found || valid;
      }
    }
    cur = (ANY_HIT && h.found) || sp == 0 ? BVH_DONE : stack[BVH_THREADS * --sp];
  }
  return h;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BVH_THREADS)
    bvh_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                    const float* __restrict__ root, const float* __restrict__ nodes,
                    const float* __restrict__ rows, int n, int num_tris, int* __restrict__ taken,
                    float* __restrict__ out_t, int* __restrict__ out_prim,
                    float* __restrict__ out_b1, float* __restrict__ out_b2,
                    unsigned char* __restrict__ out_found, int* __restrict__ out_tests) {
  __shared__ int stacks[BVH_MAX_STACK * BVH_THREADS];
  const float4 root0 = __ldg(reinterpret_cast<const float4*>(root));
  const float4 root1 = __ldg(reinterpret_cast<const float4*>(root) + 1);
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(taken, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) break;
    const int i = base + lane;
    if (i < n) {
      const Ray r = load_ray(o, d, t_lo, t_hi, i);
      const BvhHit h = bvh_walk_ray<ANY_HIT>(r, root0, root1, reinterpret_cast<const float4*>(nodes),
                                             reinterpret_cast<const float4*>(rows), num_tris,
                                             stacks + threadIdx.x);
      out_t[i] = h.t;
      out_prim[i] = h.prim;
      out_b1[i] = h.b1;
      out_b2[i] = h.b2;
      out_found[i] = h.found ? 1 : 0;
      out_tests[i] = h.tests;
    }
  }
}

// Blocks of a persistent launch: as many as fit on the device at once, and
// no more than n rays need.
template <bool ANY_HIT>
int bvh_grid(int n, cudaError_t& err) {
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_walk_kernel<ANY_HIT>,
                                                        BVH_THREADS, 0);
  const int need = (n + BVH_THREADS - 1) / BVH_THREADS;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  return need < fit ? need : fit;
}

}  // namespace

// Kernel G: root (8,), nodes (max(R, 1), 16) and rows (max(P, 1), 12)
// float32, 16-byte aligned (the wrapper checks, and that the tree's depth
// fits BVH_MAX_STACK); taken is one int32 set to 0 (the rays the persistent
// warps have taken); out_found is one byte per ray.
extern "C" int lf_bvh_walk(const float* o, const float* d, const float* t_lo, const float* t_hi,
                           const float* root, const float* nodes, const float* rows, int n,
                           int num_tris, int any_hit, int* taken, float* out_t, int* out_prim,
                           float* out_b1, float* out_b2, unsigned char* out_found, int* out_tests,
                           void* stream) {
  if (n > 0) {
    cudaError_t err;
    const int grid = any_hit ? bvh_grid<true>(n, err) : bvh_grid<false>(n, err);
    if (err != cudaSuccess) return (int)err;
    if (any_hit)
      bvh_walk_kernel<true><<<grid, BVH_THREADS, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, root, nodes, rows, n, num_tris, taken, out_t, out_prim, out_b1, out_b2,
          out_found, out_tests);
    else
      bvh_walk_kernel<false><<<grid, BVH_THREADS, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, root, nodes, rows, n, num_tris, taken, out_t, out_prim, out_b1, out_b2,
          out_found, out_tests);
  }
  return (int)cudaGetLastError();
}
