// Ray / triangle / sphere intersection kernels for Hopper (sm_90a).
//
// These replace the Pallas TPU kernel family of
// lens_flare_tpu/ops/intersect_pallas.py, all reached through _launch
// (intersect_pallas.py:1267) and pl.pallas_call:
//
//   A  lf_tree_closest  <- _make_kernel(any_hit=False)        :214, call :1392
//                          (VMEM mode and the HBM-streaming mode, stream=True)
//   B  lf_tree_any_hit  <- _make_kernel(any_hit=True)         :214, call :1392
//                          (VMEM and stream modes; warp per ray)
//   D  lf_tree_closest_shade <- _make_kernel(shade=True)      :214, call :1392
//                          (VMEM mode and stream_shade; warp per ray): A's
//                          results at chunk batch 1, plus the winning
//                          triangle slot's shading row
//   C  lf_brute         <- _make_brute_kernel(any_hit=True)   :877, call :1292
//                          (closest=1 selects _make_brute_kernel(any_hit=False))
//   E  lf_tree_closest_mxu <- _make_kernel(mxu=True)          :214, walk :559-629,
//                          features mxu_fmat :310-332, coefficient planes
//                          PallasScene.__init__ :1153-1214, call :1392
//   F  lf_tree_group    <- _make_kernel(top_batch>1)          :214, group_body
//                          :699-799, any-hit exit :803-816, call :1392
//                          (closest hit, any hit and shade: three instances)
//   _sphere_pass (:840) runs at the end of every kernel.
//
// Every kernel walks the same two-level cluster tree (accel/wide.py: B1 top
// boxes, B1*B2 child boxes, K triangles per child) from global memory.  The
// TPU walked a 512-2048-lane tile in lockstep and culled whole clusters per
// tile; its VMEM residency and HBM page ring have no counterpart here: the
// tree is 48 bytes per triangle slot plus 32 per box (25 MB of triangle rows
// and 0.5 MB of boxes for the 524k-triangle terrain), which sits mostly in
// the 50 MB L2.
//
// Two designs:
// - B and D, one warp per ray (warp_walk_kernel).  What bounded them as one
//   thread per ray was latency, not bytes or operations: a 64k-lane
//   wavefront gave only 2,048 warps, each thread ran a long chain of
//   dependent scalar loads from addresses private to it, and a warp ran the
//   union of its 32 rays' tops and chunks.  A warp now walks one ray: its
//   lanes test 32 top or child boxes at once (two float4 each) and one
//   triangle each of a chunk (three float4 of the 48-byte row), so every
//   load coalesces, a 64k-lane call has 65,536 warps, and no lane waits on
//   another ray's path.  Ballots pick the boxes hit and warp shuffles
//   reduce a chunk in the sequential order (see warp_walk_kernel).
// - A, C, E and F, one thread per ray, carried over from the TPU's
//   per-lane walk; they keep the costs above.
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

// Kernel A: the two-level walk, one thread per ray, chunk batch 1 or 2.
__global__ void tree_kernel(const float* __restrict__ o, const float* __restrict__ d,
                            const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                            const float* __restrict__ top, const float* __restrict__ child,
                            const float* __restrict__ tri, const float* __restrict__ sph, int n,
                            int b1, int b2, int k, int n_spheres, int chunk_batch,
                            float* __restrict__ out_t, int* __restrict__ out_slot,
                            float* __restrict__ out_bary, int* __restrict__ out_tests) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;

  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;

  for (int tp = 0; r.finite && tp < b1; ++tp) {
    const float t_clip = min_nan(t_hi, best_t);
    // child boxes lie inside their top box, so this prunes exactly the
    // children the tile-level walk would have masked off for this lane
    if (b1 > 1 && !box_hit(top + 8 * tp, r, t_lo, t_clip)) continue;
    Batch bt;
    int in_batch = 0;
    for (int c = 0; c < b2; ++c) {
      const int node = tp * b2 + c;
      if (!box_hit(child + 8 * node, r, t_lo, t_clip)) continue;
      tests += k;  // the chunk mask is fixed for the whole top
      const float* rows = tri + (size_t)node * k * 12;
      if (in_batch == 0) batch_reset(bt, t_hi, best_t);
      for (int s = 0; s < k; ++s) batch_test(bt, mt_terms(rows + 12 * s, r), node * k + s, t_lo);
      if (++in_batch == chunk_batch) {
        batch_commit(bt, best_t, slot, ob1, ob2);
        in_batch = 0;
      }
    }
    if (in_batch > 0) batch_commit(bt, best_t, slot, ob1, ob2);
  }

  sphere_pass(sph, n_spheres, b1 * b2 * k, r, best_t, slot, tests);

  out_t[i] = best_t;
  out_slot[i] = slot;
  out_bary[2 * i] = ob1;
  out_bary[2 * i + 1] = ob2;
  out_tests[i] = tests;
}

// Kernels B (ANY_HIT) and D (closest hit at chunk batch 1 plus shading
// rows): one warp walks one ray.  The result is the sequential walk's (A's
// at chunk batch 1, the plain version tree_plain), bit for bit and with
// the same per-lane tests; only who does which test changes.
//
// 1. Tops go in words of 32, one per lane.  A ballot of each lane's top box
//    under [t_lo, hi_pre], the loosest clip the walk can use (t_hi; for any
//    hit max(t_hi, 0)), gives the candidates: the slab test is monotone in
//    the clip, so a top that is missed there is missed under every clip.
// 2. The candidates go in ascending order.  The clip is fixed at the top's
//    start (min(t_hi, best_t); for any hit t_hi, or 0 once occluded), and a
//    candidate is tested again, warp-uniformly, where the clip is tighter.
// 3. The top's children go in words of 32: a ballot of the child boxes hit
//    under the clip, K tests charged per set bit, then each set child's chunk
//    in ascending order, one slot per lane in strides of 32 (K != 32 masks
//    or loops).
// 4. Closest hit: a chunk's limit is min(t_hi, best_t) at its start; the
//    warp's minimum t (fminf butterfly), then a ballot of the slots tied at
//    it.  Merged stride by stride into the chunk's state exactly as
//    batch_test's sequential update would: the first tied slot's t (its
//    sign of zero too), the highest tied slot id, and fmaxf over the tied
//    barycentrics in ascending slot order.  The chunk commits where its t
//    beats best_t.  Any hit: __any_sync; once occluded, the top's charged
//    tests stand, and the walk goes on under [t_lo, 0] only where t_lo <= 0.
// 5. A ray with a NaN or an empty interval (t_lo > t_hi) hits no box under
//    any clip: it skips the walk in one uniform branch.
// 6. D takes the winner's 10-float row before the sphere pass (lanes 0-9
//    copy one float each, zeros where no triangle won), as the TPU kernel's
//    one-hot select did (intersect_pallas.py:524-542, :843-847).  Every lane
//    then runs the sphere pass on the same values; lane 0 writes the outputs.
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

// One chunk of closest hit: the sequential batch_reset / batch_test x K /
// batch_commit, with the slots spread over the warp.
__device__ __forceinline__ void warp_chunk_closest(const float* __restrict__ tri, int node, int k,
                                                   int lane, const Ray& r, float& best_t,
                                                   int& slot, float& ob1, float& ob2) {
  const float limit = min_nan(r.t_hi, best_t);
  float bt = KINF;  // batch state, as Batch: t, max id and barycentrics at it
  int bid = -1;
  float bb1 = -KINF, bb2 = -KINF;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    float tt = 0.0f, b1 = 0.0f, b2 = 0.0f;
    bool valid = false;
    if (s < k)
      valid = closest_terms(mt_terms4(tri + ((size_t)node * k + s) * 12, r), r.t_lo, limit, tt, b1,
                            b2);
    const float mn = warp_min(valid ? tt : KINF);
    if (mn > bt) continue;  // every valid slot of the stride loses
    const unsigned tied = __ballot_sync(FULL_MASK, valid && tt == mn);
    if (tied == 0u) continue;  // no valid slot at all
    unsigned rest = tied;
    if (mn < bt) {  // the first tied slot replaces the state
      const int first = __ffs(tied) - 1;
      bt = __shfl_sync(FULL_MASK, tt, first);
      bb1 = __shfl_sync(FULL_MASK, b1, first);
      bb2 = __shfl_sync(FULL_MASK, b2, first);
      rest &= rest - 1u;
    }
    bid = max(bid, node * k + s0 + 31 - __clz(tied));
    while (rest != 0u) {  // the others tie with it, in slot order
      const int l = __ffs(rest) - 1;
      rest &= rest - 1u;
      bb1 = fmaxf(bb1, __shfl_sync(FULL_MASK, b1, l));
      bb2 = fmaxf(bb2, __shfl_sync(FULL_MASK, b2, l));
    }
  }
  if (bt < best_t) {
    best_t = bt;
    slot = bid;
    ob1 = bb1;
    ob2 = bb2;
  }
}

// One chunk of any hit: whether a slot occludes in [t_lo, t_hi].
__device__ __forceinline__ bool warp_chunk_occludes(const float* __restrict__ tri, int node, int k,
                                                    int lane, const Ray& r) {
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    const bool occ =
        s < k && occludes(mt_terms4(tri + ((size_t)node * k + s) * 12, r), r.t_lo, r.t_hi);
    if (__any_sync(FULL_MASK, occ)) return true;
  }
  return false;
}

template <bool ANY_HIT>
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
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;

  // the walk's state, the same in every lane
  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;
  bool occluded = false;

  if (r.finite && t_lo <= t_hi) {
    const float hi_pre = ANY_HIT ? fmaxf(t_hi, 0.0f) : t_hi;
    bool done = false;
    for (int tp0 = 0; tp0 < b1 && !done; tp0 += 32) {
      unsigned cand = 1u;  // a single-level tree has no top box to test
      if (b1 > 1) {
        const int tp = tp0 + lane;
        cand = __ballot_sync(FULL_MASK, tp < b1 && box_hit4(top + 8 * tp, r, t_lo, hi_pre));
      }
      while (cand != 0u) {
        const int tp = tp0 + __ffs(cand) - 1;
        cand &= cand - 1u;
        // once occluded, t_clip = 0: no box can be hit unless t_lo <= 0
        if (ANY_HIT && occluded && !(t_lo <= 0.0f)) {
          done = true;
          break;
        }
        const float t_clip = ANY_HIT ? (occluded ? 0.0f : t_hi) : min_nan(t_hi, best_t);
        if (b1 > 1 && t_clip != hi_pre && !box_hit4(top + 8 * tp, r, t_lo, t_clip)) continue;
        for (int c0 = 0; c0 < b2; c0 += 32) {
          const int c = c0 + lane;
          const unsigned hits =
              __ballot_sync(FULL_MASK, c < b2 && box_hit4(child + 8 * (tp * b2 + c), r, t_lo, t_clip));
          tests += k * __popc(hits);  // the chunk mask is fixed for the whole top
          unsigned todo = (ANY_HIT && occluded) ? 0u : hits;
          while (todo != 0u) {
            const int node = tp * b2 + c0 + __ffs(todo) - 1;
            todo &= todo - 1u;
            if (ANY_HIT) {
              if (warp_chunk_occludes(tri, node, k, lane, r)) {
                occluded = true;
                todo = 0u;
              }
            } else {
              warp_chunk_closest(tri, node, k, lane, r, best_t, slot, ob1, ob2);
            }
          }
        }
      }
    }
  }
  if (ANY_HIT && occluded) slot = 0;

  if (!ANY_HIT && lane < 10) {  // D's row: lane j copies float j
    out_shade[(size_t)10 * i + lane] = slot >= 0 ? shade[(size_t)10 * slot + lane] : 0.0f;
  }

  sphere_pass(sph, n_spheres, b1 * b2 * k, r, best_t, slot, tests);

  if (lane == 0) {
    out_t[i] = best_t;
    out_slot[i] = slot;
    out_bary[2 * i] = ob1;
    out_bary[2 * i + 1] = ob2;
    out_tests[i] = tests;
  }
}

// Kernel C: the tree-free pass over every real triangle of a tiny scene.
// Rays are grouped in 1024-lane tiles as the TPU kernel's grid was: a tile
// with no live lane (t_hi > t_lo) does no work at all, sphere tests included.
template <bool CLOSEST>
__global__ void brute_kernel(const float* __restrict__ o, const float* __restrict__ d,
                             const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                             const float* __restrict__ tri, const float* __restrict__ sph, int n,
                             int s_real, int s_pad, int n_spheres, float* __restrict__ out_t,
                             int* __restrict__ out_slot, float* __restrict__ out_bary,
                             int* __restrict__ out_tests) {
  // blockDim.x divides BRUTE_TILE: each block reads the liveness of its tile
  const int tile0 = (blockIdx.x * blockDim.x) / BRUTE_TILE * BRUTE_TILE;
  int any_live = 0;
  for (int l = tile0 + threadIdx.x; l < tile0 + BRUTE_TILE && l < n; l += blockDim.x)
    any_live |= (t_hi_in[l] > t_lo_in[l]) ? 1 : 0;
  const bool tile_live = __syncthreads_or(any_live) != 0;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;
  if (tile_live) {
    const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
    if (CLOSEST) {
      // rows in static blocks of 64, as the TPU kernel's sublane blocks
      for (int c0 = 0; c0 < s_real; c0 += BRUTE_BLOCK) {
        Batch bt;
        batch_reset(bt, r.t_hi, best_t);
        const int c1 = min(c0 + BRUTE_BLOCK, s_real);
        for (int s = c0; s < c1; ++s) batch_test(bt, mt_terms(tri + 9 * s, r), s, r.t_lo);
        batch_commit(bt, best_t, slot, ob1, ob2);
      }
    } else {
      for (int s = 0; s < s_real; ++s) {
        if (occludes(mt_terms(tri + 9 * s, r), r.t_lo, r.t_hi)) {
          slot = 0;
          break;
        }
      }
    }
    tests = (r.t_hi > r.t_lo) ? s_real : 0;
    sphere_pass(sph, n_spheres, s_pad, r, best_t, slot, tests);
  }
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
// b2.det are linear forms per slot, whose coefficients the wrapper packs
// slot-major (B1*B2*K, 4, 16) (intersect_cuda.mxu_tables).  The TPU kernel
// evaluated them as one (16,128)^T x (16,TILE) matrix product per chunk on
// its matrix unit.  Here one thread per ray walks the tree as kernel A does
// at chunk batch 1, forms f once per walked top, and for each slot of an
// active chunk takes four dot products over the ten non-zero features in
// plain float32, features 0 -> 9 (--fmad=false), then A's closest-hit
// update.  What bounds it on this card: 256 bytes of coefficients per slot
// (A reads 48) and 76 FLOP per slot for the four dots (A's cross-product
// chain is 41), both served from L2 in divergent per-thread loads, so it is
// slower than A by design.  The Hopper counterpart of the TPU's reason for
// this row -- a block's lanes sharing one chunk's (K x 4, 16) coefficients
// in shared memory and evaluating them as a tile product on the tensor
// cores with 3xTF32 mma.sync / wgmma -- is ROADMAP Queue 2's redesign.
__device__ __forceinline__ float dot10(const float* __restrict__ c, const float* f) {
  const float4 q0 = reinterpret_cast<const float4*>(c)[0];
  const float4 q1 = reinterpret_cast<const float4*>(c)[1];
  const float2 q2 = reinterpret_cast<const float2*>(c)[4];
  float acc = q0.x * f[0];
  acc = acc + q0.y * f[1];
  acc = acc + q0.z * f[2];
  acc = acc + q0.w * f[3];
  acc = acc + q1.x * f[4];
  acc = acc + q1.y * f[5];
  acc = acc + q1.z * f[6];
  acc = acc + q1.w * f[7];
  acc = acc + q2.x * f[8];
  acc = acc + q2.y * f[9];
  return acc;
}

__global__ void mxu_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                           const float* __restrict__ top, const float* __restrict__ child,
                           const float* __restrict__ coef, const float* __restrict__ centers,
                           const float* __restrict__ sph, int n, int b1, int b2, int k,
                           int n_spheres, float* __restrict__ out_t, int* __restrict__ out_slot,
                           float* __restrict__ out_bary, int* __restrict__ out_tests) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, t_lo_in, t_hi_in, i);
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;
  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;

  for (int tp = 0; r.finite && tp < b1; ++tp) {
    const float t_clip = min_nan(t_hi, best_t);
    if (b1 > 1 && !box_hit(top + 8 * tp, r, t_lo, t_clip)) continue;
    // mxu_fmat (intersect_pallas.py:310-332): products rounded, then differences
    const float* c = centers + 3 * tp;
    const float ocx = r.o[0] - c[0], ocy = r.o[1] - c[1], ocz = r.o[2] - c[2];
    const float f[10] = {1.0f, ocx, ocy, ocz, r.d[0], r.d[1], r.d[2],
                         r.d[1] * ocz - r.d[2] * ocy, r.d[2] * ocx - r.d[0] * ocz,
                         r.d[0] * ocy - r.d[1] * ocx};
    for (int ch = 0; ch < b2; ++ch) {
      const int node = tp * b2 + ch;
      if (!box_hit(child + 8 * node, r, t_lo, t_clip)) continue;
      tests += k;
      Batch bt;
      batch_reset(bt, t_hi, best_t);
      const float* cf = coef + (size_t)node * k * 64;
      for (int s = 0; s < k; ++s) {
        const float* q = cf + 64 * s;  // [det | t.det | b1.det | b2.det] x 16 features
        MT m;
        m.det = dot10(q, f);
        m.tt_n = dot10(q + 16, f);
        m.bb1_n = dot10(q + 32, f);
        m.bb2_n = dot10(q + 48, f);
        batch_test(bt, m, node * k + s, t_lo);
      }
      batch_commit(bt, best_t, slot, ob1, ob2);
    }
  }
  sphere_pass(sph, n_spheres, b1 * b2 * k, r, best_t, slot, tests);
  out_t[i] = best_t;
  out_slot[i] = slot;
  out_bary[2 * i] = ob1;
  out_bary[2 * i + 1] = ob2;
  out_tests[i] = tests;
}

// Kernel F: the top-batched group walk (row 8), closest hit (ANY_HIT and
// SHADE false), any hit (ANY_HIT) and closest hit with D's shading rows
// (SHADE).  Its t, slot, barycentrics, hits and rows equal A's, B's and D's;
// it differs from them in when the clip interval is fixed, which shows only
// in the tests counter.  To count as the TPU kernel did, lane for lane, a
// block is one tile of the TPU grid, of the size the caller passes
// (intersect_cuda.group_tile: _auto_tile's 512 lanes, or 1024 for any hit),
// tail padding lanes included (o = d = 0, t_lo = t_hi = 0,
// intersect_pallas.py:1435-1440):
// 1. the block ORs its lanes' top-box hits under [t_lo, t_hi] into a shared
//    flag per top (intersect_pallas.py:342-347), and one warp compacts the
//    flags into the ascending active-top list;
// 2. each lane walks that list in groups of TB tops: the clip is fixed at the
//    group's start (min(t_hi, best_t); [t_lo, 0] once occluded), K tests are
//    charged per child box hit under it, and the chunks are tested in group
//    order (tops in list order, children ascending) with the running best as
//    the limit (group_body, :699-799);
// 3. any hit: before each group the block stops once every lane is occluded
//    or dead (t_hi <= t_lo), the while_loop of :803-816.  An occluded lane
//    with t_lo > 0 hits no box under [t_lo, 0] and idles; one with t_lo <= 0
//    keeps being charged until its block stops.
// The children of a top lie inside its box and the slab test is monotone in
// the box bounds, so a lane that misses a top's box under the clip misses all
// its children: skipping them changes no count.  What bounds it: the same
// divergent L2 loads as A, plus one __syncthreads_or per group for any hit.
// The TPU batched tops to amortise its per-top sequential overhead, which
// one thread per ray does not have; B's and D's warp-per-ray walk, with the
// tile's list and exit kept per block, is its redesign.
constexpr int GROUP_MAX_TILE = 1024;  // the largest block, so the largest tile

template <bool ANY_HIT, bool SHADE>
__global__ void __launch_bounds__(GROUP_MAX_TILE)
    group_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_lo_in, const float* __restrict__ t_hi_in,
                 const float* __restrict__ top, const float* __restrict__ child,
                 const float* __restrict__ tri, const float* __restrict__ shade,
                 const float* __restrict__ sph, int n, int b1, int b2, int k, int n_spheres,
                 int tb, float* __restrict__ out_t, int* __restrict__ out_slot,
                 float* __restrict__ out_bary, int* __restrict__ out_tests,
                 float* __restrict__ out_shade) {
  extern __shared__ int smem[];
  int* flags = smem;       // (b1,) 1 where a lane of the tile hits the top
  int* tops = smem + b1;   // (b1,) the tile's active tops, ascending
  __shared__ int n_top_s;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < n;
  Ray r;
  if (real) {
    r = load_ray(o, d, t_lo_in, t_hi_in, i);
  } else {  // a tail padding lane of the tile
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r.o[a] = 0.0f;
      r.d[a] = 0.0f;
      r.inv[a] = safe_inv(0.0f);
    }
    r.t_lo = r.t_hi = 0.0f;
    r.finite = true;
  }
  const float t_lo = r.t_lo;
  const float t_hi = r.t_hi;

  for (int j = threadIdx.x; j < b1; j += blockDim.x) flags[j] = 0;
  __syncthreads();
  if (r.finite) {
    for (int tp = 0; tp < b1; ++tp)
      if (box_hit(top + 8 * tp, r, t_lo, t_hi)) flags[tp] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < b1; base += 32) {
      const int j = base + lane;
      const bool f = j < b1 && flags[j] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (f) tops[count + __popc(mask & ((1u << lane) - 1u))] = j;
      count += __popc(mask);
    }
    if (lane == 0) n_top_s = count;
  }
  __syncthreads();
  const int n_top = n_top_s;
  const int n_groups = (n_top + tb - 1) / tb;

  float best_t = KINF;
  int slot = -1;
  float ob1 = 0.0f, ob2 = 0.0f;
  int tests = 0;
  bool occluded = false;
  const bool dead = t_hi <= t_lo;
  const bool walks = real && r.finite;

  for (int g = 0; g < n_groups; ++g) {
    // every thread reaches this barrier: n_groups and the exit are block-uniform
    if (ANY_HIT && __syncthreads_or(!(occluded || dead)) == 0) break;
    if (!walks || (ANY_HIT && occluded && !(t_lo <= 0.0f))) continue;
    const float t_clip = ANY_HIT ? (occluded ? 0.0f : t_hi) : min_nan(t_hi, best_t);
    for (int u = 0; u < tb; ++u) {
      const int si = g * tb + u;
      if (si >= n_top) break;
      const int tp = tops[si];
      if (!box_hit(top + 8 * tp, r, t_lo, t_clip)) continue;
      for (int ch = 0; ch < b2; ++ch) {
        const int node = tp * b2 + ch;
        if (!box_hit(child + 8 * node, r, t_lo, t_clip)) continue;
        tests += k;
        const float* rows = tri + (size_t)node * k * 12;
        if (ANY_HIT) {
          if (occluded) continue;
          for (int s = 0; s < k; ++s) {
            if (occludes(mt_terms(rows + 12 * s, r), t_lo, t_hi)) {
              occluded = true;
              break;
            }
          }
        } else {
          Batch bt;
          batch_reset(bt, t_hi, best_t);
          for (int s = 0; s < k; ++s) batch_test(bt, mt_terms(rows + 12 * s, r), node * k + s, t_lo);
          batch_commit(bt, best_t, slot, ob1, ob2);
        }
      }
    }
  }
  if (!real) return;
  if (ANY_HIT && occluded) slot = 0;
  if (SHADE) {  // as kernel D: the best triangle's row, before the spheres
    float* row = out_shade + (size_t)10 * i;
    if (slot >= 0) {
      const float* src = shade + (size_t)10 * slot;
#pragma unroll
      for (int j = 0; j < 10; ++j) row[j] = src[j];
    } else {
#pragma unroll
      for (int j = 0; j < 10; ++j) row[j] = 0.0f;
    }
  }
  sphere_pass(sph, n_spheres, b1 * b2 * k, r, best_t, slot, tests);
  out_t[i] = best_t;
  out_slot[i] = slot;
  out_bary[2 * i] = ob1;
  out_bary[2 * i + 1] = ob2;
  out_tests[i] = tests;
}

constexpr int TREE_THREADS = 128;
constexpr int BRUTE_THREADS = 256;
static_assert(BRUTE_TILE % BRUTE_THREADS == 0, "a block must lie inside one brute tile");

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// rays are o (N, 3), d (N, 3), t_lo (N,), t_hi (N,); outputs t (N,),
// slot (N,), bary (N, 2), tests (N,).  Returns cudaGetLastError().
extern "C" int lf_tree_closest(const float* o, const float* d, const float* t_lo,
                               const float* t_hi, const float* top, const float* child,
                               const float* tri, const float* sph, int n, int b1, int b2, int k,
                               int n_spheres, int chunk_batch, float* out_t, int* out_slot,
                               float* out_bary, int* out_tests, void* stream) {
  if (n > 0) {
    const int grid = (n + TREE_THREADS - 1) / TREE_THREADS;
    tree_kernel<<<grid, TREE_THREADS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, tri, sph, n, b1, b2, k, n_spheres, chunk_batch, out_t,
        out_slot, out_bary, out_tests);
  }
  return (int)cudaGetLastError();
}

// Kernels D and B, one warp per ray: top, child and tri 16-byte aligned
// (the wrapper checks), any B1, B2, K >= 1.
// Kernel D: shade (B1*B2*K, 10) slot-ordered [9 corner-normal components |
// bsdf id]; out_shade (N, 10).  Chunk batch 1, as the TPU's shade mode forces
// (intersect_pallas.py:1307-1308).
extern "C" int lf_tree_closest_shade(const float* o, const float* d, const float* t_lo,
                                     const float* t_hi, const float* top, const float* child,
                                     const float* tri, const float* shade, const float* sph,
                                     int n, int b1, int b2, int k, int n_spheres, float* out_t,
                                     int* out_slot, float* out_bary, int* out_tests,
                                     float* out_shade, void* stream) {
  if (b1 < 1 || b2 < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + WALK_RAYS - 1) / WALK_RAYS;
    warp_walk_kernel<false><<<grid, 32 * WALK_RAYS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, tri, shade, sph, n, b1, b2, k, n_spheres, out_t, out_slot,
        out_bary, out_tests, out_shade);
  }
  return (int)cudaGetLastError();
}

extern "C" int lf_tree_any_hit(const float* o, const float* d, const float* t_lo,
                               const float* t_hi, const float* top, const float* child,
                               const float* tri, const float* sph, int n, int b1, int b2, int k,
                               int n_spheres, float* out_t, int* out_slot, float* out_bary,
                               int* out_tests, void* stream) {
  if (b1 < 1 || b2 < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + WALK_RAYS - 1) / WALK_RAYS;
    warp_walk_kernel<true><<<grid, 32 * WALK_RAYS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k, n_spheres, out_t, out_slot,
        out_bary, out_tests, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int lf_brute(const float* o, const float* d, const float* t_lo, const float* t_hi,
                        const float* tri, const float* sph, int n, int s_real, int s_pad,
                        int n_spheres, int closest, float* out_t, int* out_slot, float* out_bary,
                        int* out_tests, void* stream) {
  if (n > 0) {
    const int grid = (n + BRUTE_THREADS - 1) / BRUTE_THREADS;
    if (closest)
      brute_kernel<true><<<grid, BRUTE_THREADS, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, tri, sph, n, s_real, s_pad, n_spheres, out_t, out_slot, out_bary,
          out_tests);
    else
      brute_kernel<false><<<grid, BRUTE_THREADS, 0, (cudaStream_t)stream>>>(
          o, d, t_lo, t_hi, tri, sph, n, s_real, s_pad, n_spheres, out_t, out_slot, out_bary,
          out_tests);
  }
  return (int)cudaGetLastError();
}

// Kernel E: coef (B1*B2*K, 4, 16) slot-major coefficients, centers (B1, 3).
extern "C" int lf_tree_closest_mxu(const float* o, const float* d, const float* t_lo,
                                   const float* t_hi, const float* top, const float* child,
                                   const float* coef, const float* centers, const float* sph,
                                   int n, int b1, int b2, int k, int n_spheres, float* out_t,
                                   int* out_slot, float* out_bary, int* out_tests, void* stream) {
  if (n > 0) {
    const int grid = (n + TREE_THREADS - 1) / TREE_THREADS;
    mxu_kernel<<<grid, TREE_THREADS, 0, (cudaStream_t)stream>>>(
        o, d, t_lo, t_hi, top, child, coef, centers, sph, n, b1, b2, k, n_spheres, out_t, out_slot,
        out_bary, out_tests);
  }
  return (int)cudaGetLastError();
}

// Kernel F: tb tops per group (2 <= tb <= b1, multi-level trees), one block
// per tile of tile lanes (32 <= tile <= 1024, a multiple of 32); any_hit
// selects the any-hit instance, shade_rows the shade one (shade and
// out_shade as for kernel D).
extern "C" int lf_tree_group(const float* o, const float* d, const float* t_lo,
                             const float* t_hi, const float* top, const float* child,
                             const float* tri, const float* shade, const float* sph, int n,
                             int b1, int b2, int k, int n_spheres, int tb, int tile,
                             int any_hit, int shade_rows, float* out_t, int* out_slot,
                             float* out_bary, int* out_tests, float* out_shade, void* stream) {
  if (tile < 32 || tile > GROUP_MAX_TILE || tile % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + tile - 1) / tile;
    const size_t smem = 2 * sizeof(int) * (size_t)b1;
    cudaStream_t st = (cudaStream_t)stream;
    if (any_hit)
      group_kernel<true, false><<<grid, tile, smem, st>>>(
          o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k, n_spheres, tb, out_t,
          out_slot, out_bary, out_tests, nullptr);
    else if (shade_rows)
      group_kernel<false, true><<<grid, tile, smem, st>>>(
          o, d, t_lo, t_hi, top, child, tri, shade, sph, n, b1, b2, k, n_spheres, tb, out_t,
          out_slot, out_bary, out_tests, out_shade);
    else
      group_kernel<false, false><<<grid, tile, smem, st>>>(
          o, d, t_lo, t_hi, top, child, tri, nullptr, sph, n, b1, b2, k, n_spheres, tb, out_t,
          out_slot, out_bary, out_tests, nullptr);
  }
  return (int)cudaGetLastError();
}
