// Path-vertex shading for Hopper (sm_90a): kernel I, lf_shade_vertex (I-a) and lf_gather_vertex (I-b).
//
// It replaces no Pallas kernel: it stands in for the XLA fusions of
// lens_flare_tpu/integrator/path.py that shade a path vertex (finalize_hit's
// normal and row, the face-forward flip, the shading frame, next-event
// estimation over the static light slots, Russian roulette, the BSDF sample
// and the bounce ray, :279-826).  The port's plain version is the vertex
// loop of lens_flare_tpu_torch/integrator/path.py (_shade_plain,
// _gather_plain), which runs the same math as ~300 separate PyTorch
// elementwise launches a vertex.  The integrator's vertex loop is
//
//   closest-hit walk (kernel D, A or G) -> I-a -> shadow walk (B, C or G) -> I-b
//
// I-a, one thread a lane, takes the walk's raw outputs (slot or primitive,
// barycentrics, kernel D's shading row or the tri_shade row, distance,
// tests) and does, in registers: finalize_hit (a triangle's interpolated
// normal, or a sphere's geometric one from the walked ray's origin) and the
// face-forward flip; the hit point; make_coord_space (argmin's first-index
// and NaN-first rule); w_out; the emission; the throughput step of the bounce
// that reached this vertex and the emission it picks up through a delta lobe;
// for each static NEE slot the directional, point, spot or area light sample
// (shading.py, lights.py sample_light_static), the facing test, eval_f
// (diffuse or microfacet), the weight and the unoccluded contribution; the
// shadow rays in the slot-major (S*N) layout the any-hit walk reads; Russian
// roulette, sample_f of the vertex's family (the cosine-weighted lobe,
// mirror, refraction, glass or the Beckmann half vector), local_to_world and
// the bounce ray the next walk reads; and the lane's counts of rays traced,
// primitive tests and skipped NEE lanes.  I-b adds the slots' unoccluded
// contributions in torch.sum's order over a leading dim (four accumulators,
// slot s into s % 4, then combined in order), scales by
// 1/total_light_samples and adds them to the path's radiance; after the last
// vertex it writes the sample's radiance.
//
// I-a has two instances, picked on the host (ShadeArgs.general, from the
// settings' BSDF families and light slot types and the scene's spheres):
// shade_vertex_kernel<false> for scenes of diffuse and emissive BSDFs under
// directional and point lights without spheres, whose code holds nothing of
// the rest, and shade_vertex_kernel<true> for any BSDF families, spot and
// area slots and spheres.  Neither takes an environment map, -H or a
// recorded gradient (path.py _takes_vertex_kernel decides that).
//
// Bit equality with the plain version on the card: every operation is the
// plain version's, in its order, built with --fmad=false, IEEE division and
// square root, and sinf, cosf, expf, logf, atanf, powf and sqrtf without
// intrinsics, as PyTorch's CUDA kernels call them.  A PyTorch division by a
// Python number multiplies by the float reciprocal (div_true_kernel_cuda), so
// x / pi is x * (1.0f / pi_f) here too; clamp_min and clamp keep NaN; sign
// gives 0 for NaN; amax propagates NaN; x ** 2 and x ** 3 with a Python int
// are products (pow_tensor_scalar_kernel), x ** 4 and x ** 5 are powf(x, 4.0f)
// and powf(x, 5.0f), and a tensor ** tensor is powf.
//
// What bounds it on this card: bytes.  A lane reads its walk outputs (24
// bytes and a 40-byte shading row), its ray (28), three tape uniforms (12)
// and, past the camera vertex, its state (64), and writes its state (64),
// its bounce ray and point (44) and per slot a shadow ray (32) and a
// contribution (12); I-b reads per slot the occlusion, the tests and the
// contribution (20) and 20-32 bytes of state, and writes 16.  That is 376
// bytes a lane at the camera vertex and 452 past it with two slots
// (bench_kernels.vertex_bytes), 7.4 and 8.8 us for a 65,536-lane vertex at
// 3.35 TB/s, against ~10 operations a byte of float work, far below the
// card's ratio.  The general instance reads besides, past the camera vertex,
// the walked ray's origin (12), glass's coin (4) when a bounce follows, and
// two uniforms (8) per area slot: 516 bytes a lane at the camera vertex and
// 604 past it with the Cornell box's four slots, one of them an area light (10.1 and 11.8 us).
// So the design keeps every intermediate in registers, reads each lane's
// rows once (the few material, light and sphere rows through __ldg, which
// stay in L1), writes each output once, and launches one thread a lane in
// blocks of 256 with no shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SHADE_THREADS = 256;
constexpr int MAX_SLOTS = 16;  // path.py VERTEX_MAX_SLOTS

// scene/collada.py BSDF codes, scene/build.py light codes
constexpr int BSDF_DIFFUSE = 0, BSDF_EMISSION = 1, BSDF_MIRROR = 2, BSDF_MICROFACET = 3, BSDF_REFRACTION = 4,
              BSDF_GLASS = 5;
constexpr int LT_DIRECTIONAL = 1, LT_POINT = 2, LT_AREA = 3, LT_SPOT = 5;

// flag bits of a lane's state (istate column 3)
constexpr int F_ALIVE = 1;   // the path reached this vertex (the plain version's cont / active)
constexpr int F_BOUNCE = 2;  // the bounce sampled here continues (traced with t_hi 1e30)
constexpr int F_HIT0 = 4;    // the camera ray hit
constexpr int F_DELTA = 8;   // this vertex's BSDF is a delta lobe

}  // namespace

// The argument blocks, filled by path.py's ctypes Structures of the same
// fields in the same order.  Pointers to the lane arrays that alias between
// vertices (dir and bd, org and bo, ray_thi and bthi, base and pb) carry no
// __restrict__: a thread reads its lane before it writes it.
struct ShadeArgs {
  // the closest-hit walk of this vertex
  const float* t;              // (N,) distance (the walk's miss value where not found)
  const int* hit_id;           // (N,) slot (with smap) or primitive id (smap null, kernel G)
  const int* smap;             // slot -> primitive id, or null
  const unsigned char* found;  // (N,) bool, or null: found = hit_id >= 0
  const float* b1;             // barycentrics, lane i at b1[i * bstride]
  const float* b2;
  const int* tests;            // (N,) primitive tests of the walk
  const float* rows;           // (N, 10) kernel D's shading rows, or null: tri_shade[prim]
  // the walked ray: its base point, origin, direction and t_hi
  const float* base;           // (N, 3) camera origin, or the previous vertex's point
  const float* org;            // (N, 3) the ray's origin (the camera's, or the offset bounce origin)
  const float* dir;            // (N, 3)
  const float* ray_thi;        // (N,)
  const float* tape;           // (N, tape_u) uniforms
  const unsigned char* valid;  // (N,) bool, or null: every lane counts
  // tables
  const float* tri_shade;      // (num_tris, 10) [corner normals | bsdf id]
  const int* bsdf_type;        // (B,)
  const float* albedo;         // (B, 3)
  const float* emit;           // (B, 3) the BSDF table's radiance
  const float* light_rad;      // (L, 3)
  const float* light_pos;      // (L, 3)
  const float* light_dir;      // (L, 3)
  // tables the general instance reads
  const float* reflectance;    // (B, 3) mirror, glass
  const float* transmittance;  // (B, 3) refraction, glass
  const float* eta;            // (B, 3) microfacet conductor
  const float* k;              // (B, 3)
  const float* alpha;          // (B,) microfacet roughness
  const float* ior;            // (B,) refraction, glass
  const float* light_dim_x;    // (L, 3) area: x edge; spot: (cos cone, exponent, 0)
  const float* light_dim_y;    // (L, 3) area: y edge
  const float* light_area;     // (L,)
  const float* sph_center;     // (n_sph, 3)
  const int* sph_bsdf;         // (n_sph,)
  // state, updated in place (written whole at vertex 0)
  float* fstate;               // (N, 12) [L0 | L indirect | throughput | pending step]
  int* istate;                 // (N, 4) [rays | tests | skipped | flags]
  // outputs
  float* so;                   // (S*N, 3) shadow-ray origins, slot-major
  float* sd;                   // (S*N, 3) directions
  float* stlo;                 // (S*N,)
  float* sthi;                 // (S*N,)
  float* contrib;              // (S*N, 3) contribution if unoccluded (0 where the lane is not live)
  float* bo;                   // (N, 3) bounce-ray origin
  float* bd;                   // (N, 3) bounce direction: the next vertex's dir
  float* btlo;                 // (N,)
  float* bthi;                 // (N,)
  float* pb;                   // (N, 3) this vertex's point: the next vertex's base
  long long n;
  long long tape_u;
  long long bstride;
  int num_tris;
  int n_sph;                   // spheres (primitives num_tris .. num_tris + n_sph - 1)
  int vertex;
  int sample_bounce;           // a bounce follows this vertex
  int s_tape;                 // max(total_light_samples, 1): NEE uniforms per block / 2
  int emission_family;         // the settings' families hold BSDF_EMISSION (sample_f zeroes its f)
  int general;                 // launch shade_vertex_kernel<true>
  int n_slots;
  int slot_row[MAX_SLOTS];
  int slot_code[MAX_SLOTS];
};

struct GatherArgs {
  const float* contrib;        // (S*N, 3)
  const int* occ_slot;         // (S*N,) any-hit slot (occluded: >= 0), or null
  const unsigned char* occ_found;  // (S*N,) bool (kernel G), used when occ_slot is null
  const int* occ_tests;        // (S*N,)
  float* fstate;
  int* istate;
  float* radiance;             // (N, 3) the sample's radiance, written at the last vertex
  long long n;
  int vertex;
  int last;
  int indirect;                // the path has bounces: L = L0 + L indirect
  int n_slots;
  float inv_total;             // (float)(1 / total_light_samples) as PyTorch computes it
};

namespace {

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return isnan(v) ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ float nanmax(float a, float b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float sign_of(float a) { return (float)((0.0f < a) - (a < 0.0f)); }
__device__ __forceinline__ float dot3(const float* a, const float* b) { return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]; }
__device__ __forceinline__ float norm3(const float* v) { return sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]); }

__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// v / clamp_min(norm3(v), 1e-30), in place
__device__ __forceinline__ void normalize(float* v) {
  const float nrm = clamp_min(norm3(v), (float)1e-30);
  v[0] = v[0] / nrm;
  v[1] = v[1] / nrm;
  v[2] = v[2] / nrm;
}

// path.py _offset_origin: p + n * sign(n . w) * (1e-4 * max(amax|p|, 1))
__device__ __forceinline__ void offset_origin(const float* p, const float* n, const float* w, float* o) {
  const float side = sign_of(dot3(n, w));
  const float scale = clamp_min(nanmax(nanmax(fabsf(p[0]), fabsf(p[1])), fabsf(p[2])), 1.0f) * (float)1e-4;
  o[0] = p[0] + (n[0] * side) * scale;
  o[1] = p[1] + (n[1] * side) * scale;
  o[2] = p[2] + (n[2] * side) * scale;
}

// torch.argmin's rule (LessOrNan): NaN first, then the smaller, ties to the lower index
__device__ __forceinline__ bool less_or_nan(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

constexpr float PI_F = 3.14159265358979323846f;

// shading.py _smith_g1 of a local direction's z and the clamped roughness
__device__ __forceinline__ float smith_g1(float wz, float alpha) {
  const float cos_t = fabsf(wz);
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float a = cos_t / clamp_min(alpha * sin_t, (float)1e-12);
  const float g = ((float)3.535 * a + ((float)2.181 * a) * a) / ((a * (float)2.276 + 1.0f) + ((float)2.577 * a) * a);
  return (a >= (float)1.6 || sin_t == 0.0f) ? 1.0f : g;
}

// shading.py _microfacet_f: Beckmann D x Smith G x conductor Fresnel of BSDF row b, wi and wo local
__device__ __forceinline__ void microfacet_f(const ShadeArgs& a, int b, const float* wi, const float* wo, float* f) {
  const bool valid = wi[2] > 0.0f && wo[2] > 0.0f;
  float h[3] = {wi[0] + wo[0], wi[1] + wo[1], wi[2] + wo[2]};
  normalize(h);
  const float alpha = clamp_min(__ldg(a.alpha + b), (float)1e-4);
  const float cos_h = clamp(h[2], (float)1e-6, 1.0f);
  const float tan2 = (1.0f - cos_h * cos_h) / (cos_h * cos_h);
  const float D = expf(-tan2 / (alpha * alpha)) / (((alpha * PI_F) * alpha) * powf(cos_h, 4.0f));
  const float G = smith_g1(wi[2], alpha) * smith_g1(wo[2], alpha);
  const float c = fabsf(wi[2]);  // fresnel_conductor
  const float c2 = c * c;
  const float q = (G * D) / ((float)4.0 * clamp_min(wo[2] * wi[2], (float)1e-6));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float eta = __ldg(a.eta + 3 * b + ch), kk = __ldg(a.k + 3 * b + ch);
    const float e2k2 = eta * eta + kk * kk;
    const float tec = (eta * 2.0f) * c;
    const float rs = ((e2k2 - tec) + c2) / ((e2k2 + tec) + c2);
    const float rp = ((e2k2 * c2 - tec) + 1.0f) / ((e2k2 * c2 + tec) + 1.0f);
    f[ch] = valid ? ((rs + rp) * 0.5f) * q : 0.0f;
  }
}

// shading.py sample_f's branches for the delta and microfacet families of BSDF row b, type t, over the
// cosine-weighted sample already in f, wl, pdf and valid (which diffuse and emission keep); wo local,
// (cp, sp) = (cos, sin) of the sample's phi, coin: glass's reflect-or-refract uniform
__device__ __forceinline__ void sample_family(const ShadeArgs& a, int t, int b, const float* wo, float xi1, float cp,
                                              float sp, float coin, float* f, float* wl, float& pdf, bool& valid) {
  if (t == BSDF_MIRROR || t == BSDF_GLASS || t == BSDF_REFRACTION) {
    const float wm[3] = {-wo[0], -wo[1], wo[2]};
    const float cos_m = clamp_min(fabsf(wm[2]), (float)1e-6);
    if (t == BSDF_MIRROR) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f[c] = __ldg(a.reflectance + 3 * b + c) / cos_m;
        wl[c] = wm[c];
      }
      pdf = 1.0f;
      valid = fabsf(wo[2]) > (float)1e-6;
      return;
    }
    const float ior = __ldg(a.ior + b);
    const bool entering = wo[2] > 0.0f;
    const float er = entering ? 1.0f / ior : ior;  // eta_i / eta_t
    const float er2 = er * er;
    const float sin2_t = er2 * clamp_min(1.0f - wo[2] * wo[2], 0.0f);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
    const float wr[3] = {-er * wo[0], -er * wo[1], entering ? -cos_t : cos_t};
    const float cos_r = clamp_min(fabsf(wr[2]), (float)1e-6);
    if (t == BSDF_REFRACTION) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f[c] = (__ldg(a.transmittance + 3 * b + c) / cos_r) / er2;
        wl[c] = wr[c];
      }
      pdf = 1.0f;
      valid = !tir;
      return;
    }
    // glass: fresnel_schlick, then the coin
    const float x = (1.0f - ior) / (ior + 1.0f);
    const float r0 = x * x;
    const float R = r0 + (1.0f - r0) * powf(1.0f - fabsf(wo[2]), 5.0f);
    const float r_eff = tir ? 1.0f : R;
    const bool reflect = coin < r_eff;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[c] = reflect ? (r_eff * __ldg(a.reflectance + 3 * b + c)) / cos_m
                     : (((1.0f - r_eff) * __ldg(a.transmittance + 3 * b + c)) / cos_r) / er2;
      wl[c] = reflect ? wm[c] : wr[c];
    }
    pdf = reflect ? r_eff : 1.0f - r_eff;
    valid = pdf > 0.0f;
    return;
  }
  if (t == BSDF_MICROFACET) {
    const float alpha = clamp_min(__ldg(a.alpha + b), (float)1e-4);
    const float a2 = alpha * alpha;
    const float theta_h = atanf(sqrtf(clamp_min(-a2 * logf(clamp_min(1.0f - xi1, (float)1e-12)), 0.0f)));
    const float sin_h = sinf(theta_h), cos_h = cosf(theta_h);
    const float h[3] = {sin_h * cp, sin_h * sp, cos_h};
    const float wo_h = dot3(wo, h);
#pragma unroll
    for (int c = 0; c < 3; ++c) wl[c] = ((2.0f * wo_h) * h[c]) - wo[c];
    const float cc = clamp_min(cos_h, (float)1e-6);
    const float tq = sin_h / cc;
    const float tan2_h = tq * tq;
    const float p_theta = ((2.0f * sin_h) / (a2 * ((cc * cc) * cc))) * expf(-tan2_h / a2);
    const float pdf_h = (p_theta * (float)(1.0 / (2.0 * 3.14159265358979323846))) / clamp_min(sin_h, (float)1e-9);
    pdf = pdf_h / clamp_min((float)4.0 * wo_h, (float)1e-9);
    valid = wl[2] > 0.0f && wo[2] > 0.0f && pdf > (float)1e-9;
    microfacet_f(a, b, wl, wo, f);
  }
}

template <bool G>
__global__ void shade_vertex_kernel(const ShadeArgs a) {
  const long long i = (long long)blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  constexpr float INV_PI = 1.0f / 3.14159265358979323846f;  // the reciprocal of (float)pi, rounded
  constexpr float BVH_INF = (float)1e30;

  // -- the walk's hit (path.py trace_closest, ops/intersect.py finalize_hit)
  const int id = __ldg(a.hit_id + i);
  const bool found = a.found ? __ldg(a.found + i) != 0 : id >= 0;
  const float t = found ? __ldg(a.t + i) : BVH_INF;
  const int prim = a.smap ? (found ? __ldg(a.smap + id) : -1) : id;
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  int bsdf = 0;
  const bool is_tri = prim >= 0 && prim < a.num_tris;
  if (is_tri) {
    const float* row = a.rows ? a.rows + 10 * i : a.tri_shade + 10 * (long long)prim;
    const float b1 = __ldg(a.b1 + i * a.bstride), b2 = __ldg(a.b2 + i * a.bstride);
    const float b0 = (1.0f - b1) - b2;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nrm[c] = (b0 * __ldg(row + c) + b1 * __ldg(row + 3 + c)) + b2 * __ldg(row + 6 + c);
    normalize(nrm);
    bsdf = (int)__ldg(row + 9);
  }
  float d[3], base[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = a.dir[3 * i + c];
    base[c] = a.base[3 * i + c];
  }
  if (G && !is_tri && a.n_sph > 0) {
    // the sphere branch, which finalize_hit also takes for a miss (sphere 0, t = 1e30)
    const int over = prim - a.num_tris < 0 ? 0 : prim - a.num_tris;
    const int sph = over > a.n_sph - 1 ? a.n_sph - 1 : over;
#pragma unroll
    for (int c = 0; c < 3; ++c) nrm[c] = (a.org[3 * i + c] + d[c] * t) - __ldg(a.sph_center + 3 * sph + c);
    normalize(nrm);
    bsdf = __ldg(a.sph_bsdf + sph);
  }
  const int type = __ldg(a.bsdf_type + bsdf);
  const bool transmissive = type == BSDF_REFRACTION || type == BSDF_GLASS;
  if (dot3(nrm, d) > 0.0f && !transmissive && found) {  // _orient_normals
    nrm[0] = -nrm[0];
    nrm[1] = -nrm[1];
    nrm[2] = -nrm[2];
  }
  float em[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) em[c] = type == BSDF_EMISSION ? __ldg(a.emit + 3 * bsdf + c) : 0.0f;

  // -- the state: the camera vertex starts it, a bounce vertex steps it
  float* fs = a.fstate + 12 * i;
  int* is = a.istate + 4 * i;
  float l0[3], lind[3], thr[3];
  int rays, tests, skipped, flags;
  bool alive;
  if (a.vertex == 0) {
    alive = found;
    flags = found ? F_ALIVE | F_HIT0 : 0;
    rays = tests = skipped = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      l0[c] = em[c];  // get_emission; the gather adds the NEE estimate
      lind[c] = 0.0f;
      thr[c] = 1.0f;
    }
  } else {
    const int in_flags = is[3];
    rays = is[0];
    tests = is[1];
    skipped = is[2];
    alive = (in_flags & F_BOUNCE) && found;  // cont & nxt.hit
    flags = (in_flags & F_HIT0) | (alive ? F_ALIVE : 0);
    const bool delta = in_flags & F_DELTA;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      l0[c] = fs[c];
      const float t_in = fs[6 + c];
      thr[c] = alive ? t_in * fs[9 + c] : t_in;
      lind[c] = fs[3 + c] + ((alive && delta) ? thr[c] * em[c] : 0.0f);  // emission through a delta lobe
    }
  }
  rays += a.ray_thi[i] > 0.0f;
  tests += __ldg(a.tests + i);

  // -- the vertex point: NEE's (the walk's t, 1e30 on a miss, past the camera vertex) and the
  // bounce's base (t where hit, else 0)
  const float ts = found ? t : 0.0f;
  float pb[3], pn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pb[c] = base[c] + d[c] * ts;
    pn[c] = a.vertex == 0 ? pb[c] : base[c] + d[c] * t;
  }

  // -- shading frame (make_coord_space) and w_out = world_to_local(frame, -d)
  float fx[3], fy[3], fz[3], h[3];
  {
    const float ab[3] = {fabsf(nrm[0]), fabsf(nrm[1]), fabsf(nrm[2])};
    int sm = 0;
    if (less_or_nan(ab[1], 1, ab[sm], sm)) sm = 1;
    if (less_or_nan(ab[2], 2, ab[sm], sm)) sm = 2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[c] = c == sm ? 1.0f : nrm[c];
      fz[c] = nrm[c];
    }
    normalize(fz);
    cross(h, fz, fy);
    normalize(fy);
    cross(fz, fy, fx);
    normalize(fx);
  }
  const float nd[3] = {-d[0], -d[1], -d[2]};
  const float w_out[3] = {dot3(fx, nd), dot3(fy, nd), dot3(fz, nd)};

  // -- NEE over the static slots (direct_lighting)
  const bool nee_active = alive && (type == BSDF_DIFFUSE || type == BSDF_MICROFACET);
  const bool counted = a.valid ? __ldg(a.valid + i) != 0 : true;
  const int block = 4 + 2 * a.s_tape;  // a bounce's tape: [rr 1 | bsdf 3 | NEE 2S]
  float fd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) fd[c] = type == BSDF_DIFFUSE ? __ldg(a.albedo + 3 * bsdf + c) * INV_PI : 0.0f;
  for (int s = 0; s < a.n_slots; ++s) {
    const int row = a.slot_row[s];
    const int code = a.slot_code[s];
    float rad[3], wi[3], dist;
    float pdf = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] = __ldg(a.light_rad + 3 * row + c);
    if (code == LT_DIRECTIONAL) {
#pragma unroll
      for (int c = 0; c < 3; ++c) wi[c] = __ldg(a.light_dir + 3 * row + c);
      dist = (float)1e30;  // envlight.INF
    } else if (!G || code == LT_POINT || code == LT_SPOT) {  // _unit(position - p)
#pragma unroll
      for (int c = 0; c < 3; ++c) wi[c] = __ldg(a.light_pos + 3 * row + c) - pn[c];
      dist = norm3(wi);
      const float dm = clamp_min(dist, (float)1e-30);
      wi[0] = wi[0] / dm;
      wi[1] = wi[1] / dm;
      wi[2] = wi[2] / dm;
      if (G && code == LT_SPOT) {  // _spot_scale
        const float nw[3] = {-wi[0], -wi[1], -wi[2]};
        const float ld[3] = {__ldg(a.light_dir + 3 * row), __ldg(a.light_dir + 3 * row + 1),
                             __ldg(a.light_dir + 3 * row + 2)};
        const float cos_cone = __ldg(a.light_dim_x + 3 * row), fall = __ldg(a.light_dim_x + 3 * row + 1);
        const float sbase = clamp((dot3(nw, ld) - cos_cone) / clamp_min(1.0f - cos_cone, (float)1e-6), 0.0f, 1.0f);
        const float scale = powf(sbase, clamp_min(fall, (float)1e-6));
#pragma unroll
        for (int c = 0; c < 3; ++c) rad[c] = rad[c] * scale;
      }
    } else {  // LT_AREA: lights.py _area, on the slot's two uniforms
      const float* u = a.tape + i * a.tape_u + 4 + (long long)a.vertex * block + 2 * s;
      const float uv0 = __ldg(u) - 0.5f, uv1 = __ldg(u + 1) - 0.5f;
      float dl[3], ld[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dl[c] = ((__ldg(a.light_pos + 3 * row + c) + uv0 * __ldg(a.light_dim_x + 3 * row + c))
                 + uv1 * __ldg(a.light_dim_y + 3 * row + c)) - pn[c];
        ld[c] = __ldg(a.light_dir + 3 * row + c);
      }
      const float cos_l = dot3(dl, ld);
      const float sq = dot3(dl, dl);
      dist = sqrtf(sq);
      const float dm = clamp_min(dist, (float)1e-30);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wi[c] = dl[c] / dm;
        rad[c] = cos_l < 0.0f ? rad[c] : 0.0f;
      }
      pdf = sq / clamp_min(__ldg(a.light_area + row) * fabsf(cos_l), (float)1e-30);
    }
    const float wo[3] = {dot3(fx, wi), dot3(fy, wi), dot3(fz, wi)};
    const bool would = wo[2] >= 0.0f && pdf > 0.0f && counted;
    const bool live = would && nee_active;
    skipped += would && !nee_active;
    const float cos_theta = wo[2] / clamp_min(norm3(wo), (float)1e-30);
    const float weight = live ? cos_theta / clamp_min(pdf, (float)1e-30) : 0.0f;
    const long long j = (long long)s * n + i;
    if (G) {  // eval_f(-wi_obj, w_out): the diffuse or the microfacet lobe
      float f[3] = {fd[0], fd[1], fd[2]};
      if (type == BSDF_MICROFACET) microfacet_f(a, bsdf, wo, w_out, f);
#pragma unroll
      for (int c = 0; c < 3; ++c) a.contrib[3 * j + c] = ((live ? f[c] : 0.0f) * rad[c]) * weight;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) a.contrib[3 * j + c] = live ? ((live ? fd[c] : 0.0f) * rad[c]) * weight : 0.0f;
    }
    float o[3];
    offset_origin(pn, nrm, wi, o);
    const float thi = live ? dist * (float)(1.0 - 1e-3) - (float)1e-5 : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.so[3 * j + c] = o[c];
      a.sd[3 * j + c] = wi[c];
    }
    a.stlo[j] = (float)1e-5;
    a.sthi[j] = thi;
    rays += thi > 0.0f;
  }

  // -- Russian roulette and the BSDF sample (_indirect, sample_f)
  float step[3] = {0.0f, 0.0f, 0.0f};
  if (a.sample_bounce) {
    const float* u = a.tape + i * a.tape_u + 4 + 2 * a.s_tape + (long long)a.vertex * block;
    bool cont = alive && __ldg(u) >= (float)(1.0 - 0.7);
    const float xi1 = __ldg(u + 1), xi2 = __ldg(u + 2);
    const float r = sqrtf(xi1);
    const float phi = (float)(2.0 * 3.14159265358979323846) * xi2;
    const float z_cos = sqrtf(clamp_min(1.0f - xi1, 0.0f));
    const float cp = cosf(phi), sp = sinf(phi);
    float wl[3] = {r * cp, r * sp, z_cos};
    float pdf = z_cos * INV_PI;
    bool valid = pdf > 0.0f;
    float fb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) fb[c] = __ldg(a.albedo + 3 * bsdf + c) * INV_PI;
    if (G) sample_family(a, type, bsdf, w_out, xi1, cp, sp, __ldg(u + 3), fb, wl, pdf, valid);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (a.emission_family && type == BSDF_EMISSION) fb[c] = 0.0f;
    cont = cont && valid && pdf > 0.0f;  // bs.valid & (bs.pdf > 0)
    float ww[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ww[c] = (fx[c] * wl[0] + fy[c] * wl[1]) + fz[c] * wl[2];
    float o[3];
    offset_origin(pb, nrm, ww, o);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.bo[3 * i + c] = o[c];
      a.bd[3 * i + c] = ww[c];
      a.pb[3 * i + c] = pb[c];
    }
    a.btlo[i] = (float)1e-5;
    a.bthi[i] = cont ? (float)1e30 : 0.0f;
    const float cos_b = fabsf(wl[2]) / clamp_min(norm3(wl), (float)1e-30);
    const float q = cos_b / (pdf * (float)0.7);
#pragma unroll
    for (int c = 0; c < 3; ++c) step[c] = fb[c] * q;
    if (cont) flags |= F_BOUNCE;
    if (type == BSDF_MIRROR || type == BSDF_REFRACTION || type == BSDF_GLASS) flags |= F_DELTA;
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fs[c] = l0[c];
    fs[3 + c] = lind[c];
    fs[6 + c] = thr[c];
    fs[9 + c] = step[c];
  }
  is[0] = rays;
  is[1] = tests;
  is[2] = skipped;
  is[3] = flags;
}

__global__ void gather_vertex_kernel(const GatherArgs a) {
  const long long i = (long long)blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= a.n) return;
  float acc[4][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  int tests = 0;
  for (int s = 0; s < a.n_slots; ++s) {
    const long long j = (long long)s * a.n + i;
    const bool occ = a.occ_slot ? __ldg(a.occ_slot + j) >= 0 : __ldg(a.occ_found + j) != 0;
    tests += __ldg(a.occ_tests + j);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s & 3][c] = acc[s & 3][c] + (occ ? 0.0f : __ldg(a.contrib + 3 * j + c));
  }
  float* fs = a.fstate + 12 * i;
  int* is = a.istate + 4 * i;
  const int flags = is[3];
  is[1] += tests;
  float L[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ld = (((acc[0][c] + acc[1][c]) + acc[2][c]) + acc[3][c]) * a.inv_total;
    if (a.vertex == 0) {
      fs[c] = fs[c] + ld;
    } else {
      fs[3 + c] = fs[3 + c] + ((flags & F_ALIVE) ? fs[6 + c] * ld : 0.0f);
    }
    L[c] = a.indirect ? fs[c] + fs[3 + c] : fs[c];
  }
  if (a.last) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.radiance[3 * i + c] = (flags & F_HIT0) ? L[c] : 0.0f;
  }
}

}  // namespace

extern "C" int lf_shade_vertex(const ShadeArgs* args, void* stream) {
  if (args->n < 0 || args->n_slots < 0 || args->n_slots > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  if (args->n == 0) return (int)cudaGetLastError();
  const unsigned int grid = (unsigned int)((args->n + SHADE_THREADS - 1) / SHADE_THREADS);
  void (*kernel)(const ShadeArgs) = args->general ? shade_vertex_kernel<true> : shade_vertex_kernel<false>;
  kernel<<<grid, SHADE_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int lf_gather_vertex(const GatherArgs* args, void* stream) {
  if (args->n < 0 || args->n_slots < 0) return (int)cudaErrorInvalidValue;
  if (args->n == 0) return (int)cudaGetLastError();
  const unsigned int grid = (unsigned int)((args->n + SHADE_THREADS - 1) / SHADE_THREADS);
  gather_vertex_kernel<<<grid, SHADE_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
