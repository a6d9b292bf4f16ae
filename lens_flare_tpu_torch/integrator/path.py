"""Wavefront path-tracing integrator.

Counterpart of ``lens_flare_tpu/integrator/path.py``, computing the same
estimator on the same random numbers (``_rng`` reproduces the threefry
tape lane for lane):

- pinhole, thin-lens and bokeh-mask camera rays, the closest-hit trace
  (kernel D with its shading rows on shade scenes, else kernel A and the row
  gather) and hit finalization;
- next-event estimation over the static light-slot plan, one widened
  any-hit shadow wavefront per vertex (``direct_lighting``, ``:430-577``);
- Russian-roulette indirect bounces (``_indirect``, ``:704-826``), with no
  bounce sorting or compaction (both are off by default in the reference);
- per-pixel sample batches with the 95% CI stop (``render_wavefront``), and
  ``render_batch``, the building block of the Renderer's host-repacked
  adaptive render.

Ported BSDF families: diffuse and emission.  Ported lights: directional
and point.  ``make_settings`` refuses anything else.  PyTorch runs eagerly:
the bounce ``scan`` and the sample loops are Python loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import _rng
from ..ops.intersect import SceneArrays, finalize_hit
from ..ops.intersect_cuda import CudaScene, intersect
from ..scene.camera import CameraParams, generate_rays, generate_rays_bokeh, generate_rays_thin_lens
from ..scene.collada import BSDF_DIFFUSE, BSDF_MICROFACET
from .lights import PORTED_LIGHT_TYPES, LightArrays, sample_light_static
from .shading import (
    PORTED_FAMILIES,
    BSDFArrays,
    eval_f,
    get_emission,
    local_to_world,
    make_coord_space,
    norm3,
    sample_f,
    world_to_local,
)

EPS_F = 0.00001
CPDF = 0.7  # russian-roulette continuation probability (pathtracer.cpp:245)
SHADOW_BIAS = 1e-4


class RenderSettings(NamedTuple):
    """Integrator knobs (the ported subset of the reference's)."""

    ns_aa: int = 1
    max_ray_depth: int = 1
    ns_area_light: int = 1
    samples_per_batch: int = 64
    max_tolerance: float = 0.05
    indirect: bool = True
    use_thin_lens: bool = False  # thin-lens camera (bokeh mask when the bundle has one)
    light_slots: tuple = ()  # light row per NEE slot
    light_slot_types: tuple = ()  # LT_* code per NEE slot
    total_light_samples: int = 1


def make_settings(
    light_table, ns_aa=1, max_ray_depth=1, ns_area_light=1, bsdf_table=None,
    direct_hemisphere_sample=False, **kw,
) -> RenderSettings:
    """Settings with the static NEE slot plan from the host light table.

    Raises NotImplementedError for features this slice does not port, naming
    the ROADMAP item that will: nothing is silently dropped.
    """
    if direct_hemisphere_sample:
        raise NotImplementedError("hemisphere direct lighting (-H) is not ported yet (ROADMAP Queue 1, item 5)")
    lights = {int(t) for t in light_table.light_type} - set(PORTED_LIGHT_TYPES)
    if lights:
        raise NotImplementedError(
            f"light types {sorted(lights)} are not ported yet (ROADMAP Queue 1, item 4)"
        )
    if bsdf_table is not None:
        fams = {int(t) for t in bsdf_table.bsdf_type} - set(PORTED_FAMILIES)
        if fams:
            raise NotImplementedError(
                f"BSDF families {sorted(fams)} are not ported yet (ROADMAP Queue 1, item 4)"
            )
    slots = []
    for li in range(len(light_table.light_type)):
        slots.extend([li] * (1 if light_table.is_delta[li] else ns_area_light))
    return RenderSettings(
        ns_aa=ns_aa,
        max_ray_depth=max_ray_depth,
        ns_area_light=ns_area_light,
        light_slots=tuple(slots),
        light_slot_types=tuple(int(light_table.light_type[li]) for li in slots),
        total_light_samples=max(len(slots), 1),
        **kw,
    )


@dataclass
class BokehMask:
    """Aperture mask for thin-lens sampling (``path.py:178-222``, BASELINE config 2).

    Lens points are importance-sampled in proportion to the mask value.
    """

    cdf: torch.Tensor  # (H*W,) float32 inclusive value CDF
    width: int = 1
    height: int = 1

    @staticmethod
    def from_texture(values, device="cpu") -> "BokehMask":
        """The CDF is built in float64 and cast to float32, as the reference does."""
        v = np.asarray(values, np.float64).ravel()
        cdf = np.cumsum(v)
        cdf = cdf / cdf[-1]
        h, w = np.shape(values)
        return BokehMask(torch.as_tensor(cdf.astype(np.float32), device=device), w, h)

    def sample(self, u, jitter=None):
        """u (N,) uniforms -> lens points (N, 2) in [-0.5, 0.5]^2.

        x is placed in its texel by ``jitter`` (the texel centre when None),
        y by the fraction of u inside the chosen texel's CDF span.
        """
        n = self.cdf.shape[0]
        idx = torch.clamp(torch.searchsorted(self.cdf, u.contiguous(), right=True), 0, n - 1)
        lo = torch.where(idx > 0, self.cdf[torch.clamp_min(idx - 1, 0)], 0.0)
        span = torch.clamp_min(self.cdf[idx] - lo, 1e-12)
        jy = torch.clamp((u - lo) / span, 0.0, 1.0)
        jx = jitter if jitter is not None else 0.5
        y = idx // self.width
        x = idx % self.width
        return torch.stack(
            [
                (x.to(torch.float32) + jx) / self.width - 0.5,
                (y.to(torch.float32) + jy) / self.height - 0.5,
            ],
            dim=-1,
        )


class SceneBundle(NamedTuple):
    scene: SceneArrays
    bsdfs: BSDFArrays
    lights: LightArrays
    cscene: CudaScene  # cluster tree for the trace kernels
    bokeh: BokehMask | None = None  # aperture-shaped depth of field


def _offset_origin(p, n, w):
    """Offset p along n toward the side that w points to (secondary rays)."""
    side = torch.sign(n[:, 0] * w[:, 0] + n[:, 1] * w[:, 1] + n[:, 2] * w[:, 2])[:, None]
    scale = SHADOW_BIAS * torch.clamp_min(torch.abs(p).amax(dim=-1, keepdim=True), 1.0)
    return p + n * side * scale


def _trace_stats(t_hi, tests):
    """[rays traced, primitive tests, skipped] for one trace call (float64)."""
    rays = (t_hi > 0).sum(dtype=torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=t_hi.device)
    return torch.stack([rays, tests.sum(dtype=torch.float64), zero])


def _orient_normals(d, hit):
    """Face-forward shading normals (no ported family is transmissive)."""
    backface = (hit.n * d).sum(dim=-1) > 0
    flip = backface & hit.hit
    return hit._replace(n=torch.where(flip[:, None], -hit.n, hit.n))


def trace_closest(bundle: SceneBundle, o, d, t_lo, t_hi, coherent=False):
    """Closest hit, routed as the JAX package's ``trace_closest`` (``path.py:279-302``).

    Shade scenes take kernel D, whose shading rows replace the row gather,
    except for ``coherent`` (camera) wavefronts on stream scenes with
    ``stream_shade``, which keep kernel A and the gather, as the reference
    does.  Every other scene takes kernel A (C's closest hit is forced only
    by tests).  Returns (Hit, stats).
    """
    cs = bundle.cscene
    if cs.shade and not (coherent and cs.stream):
        t, prim, b1, b2, found, tests, rows = intersect(cs, o, d, t_lo, t_hi, return_shade=True)
        hit = finalize_hit(bundle.scene, o, d, t, prim, b1, b2, found, shade_rows=rows)
    else:
        t, prim, b1, b2, found, tests = intersect(cs, o, d, t_lo, t_hi)
        hit = finalize_hit(bundle.scene, o, d, t, prim, b1, b2, found)
    return _orient_normals(d, hit), _trace_stats(t_hi, tests)


def trace_occluded(bundle: SceneBundle, o, d, t_lo, t_hi):
    """Any-hit shadow query through kernel B (or C on tiny scenes). Returns (occluded, stats)."""
    _, _, _, _, found, tests = intersect(bundle.cscene, o, d, t_lo, t_hi, any_hit=True)
    return found, _trace_stats(t_hi, tests)


def tape_size(settings: RenderSettings) -> int:
    """Uniforms per (pixel, sample) lane: [jitter 2 | lens 2 | NEE 2S | per bounce: rr 1, bsdf 3, NEE 2S]."""
    s = max(settings.total_light_samples, 1)
    return 4 + 2 * s + max(settings.max_ray_depth - 1, 0) * (4 + 2 * s)


def _nee_active(bundle: SceneBundle, bsdf_id, hit_mask):
    """Lanes whose NEE estimate can be nonzero (see the reference's _nee_active)."""
    t = bundle.bsdfs.bsdf_type[bsdf_id.long()]
    return hit_mask & ((t == BSDF_DIFFUSE) | (t == BSDF_MICROFACET))


def direct_lighting(bundle: SceneBundle, settings: RenderSettings, u_tape, hit_p, n, w_out_w, bsdf_id, active=None, counted=None, frame=None):
    """NEE at a batch of shading points over the static slot plan.

    All slots are traced as one widened shadow wavefront of S*N rays.
    Returns ((N, 3) radiance, stats).
    """
    if frame is not None:
        o2w, w_out = frame
    else:
        o2w = make_coord_space(n)
        w_out = world_to_local(o2w, w_out_w)
    n_pts = hit_p.shape[0]
    n_slots = len(settings.light_slots)
    if n_slots == 0:
        return torch.zeros_like(hit_p), torch.zeros(3, dtype=torch.float64, device=hit_p.device)

    def rep(x):
        return x.repeat((n_slots,) + (1,) * (x.dim() - 1))

    parts = [
        sample_light_static(bundle.lights, row, code, hit_p, u_tape[:, 2 * s : 2 * s + 2])
        for s, (row, code) in enumerate(zip(settings.light_slots, settings.light_slot_types))
    ]
    ls_rad = torch.cat([p.radiance for p in parts])
    ls_wi = torch.cat([p.wi for p in parts])
    ls_dist = torch.cat([p.dist for p in parts])
    ls_pdf = torch.cat([p.pdf for p in parts])

    wi_obj = world_to_local(rep(o2w), ls_wi)
    facing = wi_obj[:, 2] >= 0  # pathtracer.cpp:186
    live = facing & (ls_pdf > 0)
    if counted is not None:
        live = live & rep(counted)
    skipped = torch.zeros((), dtype=torch.float64, device=hit_p.device)
    if active is not None:
        would_trace = live
        live = live & rep(active)
        skipped = would_trace.sum(dtype=torch.float64) - live.sum(dtype=torch.float64)
    cos_theta = wi_obj[:, 2] / torch.clamp_min(norm3(wi_obj), 1e-30)
    f = eval_f(bundle.bsdfs, rep(bsdf_id), -wi_obj, rep(w_out))
    contrib = f * ls_rad * (cos_theta / torch.clamp_min(ls_pdf, 1e-30))[:, None]

    occ, stats = trace_occluded(
        bundle,
        _offset_origin(rep(hit_p), rep(n), ls_wi),
        ls_wi,
        torch.full((n_slots * n_pts,), EPS_F, device=hit_p.device),
        torch.where(live, ls_dist * (1.0 - 1e-3) - EPS_F, 0.0),
    )
    use = live & ~occ
    contrib = torch.where(use[:, None], contrib, 0.0)
    out = contrib.view(n_slots, n_pts, 3).sum(dim=0) / settings.total_light_samples
    stats = stats + torch.stack([torch.zeros_like(skipped), torch.zeros_like(skipped), skipped])
    return out, stats


def radiance_sample(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, keys, px, py, width, height, valid=None):
    """One radiance sample per pixel lane (est_radiance_global_illumination).

    keys: (N, 2) per-lane RNG keys; valid: optional (N,) bool, False for
    shape padding (t_hi = 0: traces nothing, counts nothing).
    Returns ((N, 3) radiance, stats [rays, tests, skipped]).
    """
    n_lanes = px.shape[0]
    dev = px.device
    s = max(settings.total_light_samples, 1)
    tape = _rng.uniform(keys, (tape_size(settings),))  # (N, U)

    x = (px.to(torch.float32) + tape[:, 0]) / width
    y = (py.to(torch.float32) + tape[:, 1]) / height
    if settings.use_thin_lens and bundle.bokeh is not None:
        o, d = generate_rays_bokeh(cam, x, y, bundle.bokeh.sample(tape[:, 2], jitter=tape[:, 3]))
    elif settings.use_thin_lens:
        o, d = generate_rays_thin_lens(cam, x, y, tape[:, 2], tape[:, 3])
    else:
        o, d = generate_rays(cam, x, y)

    t_lo = cam.n_clip.expand(n_lanes)
    t_hi = cam.f_clip.expand(n_lanes)
    if valid is not None:
        t_hi = torch.where(valid, t_hi, 0.0)
    hit, stats = trace_closest(
        bundle, o.contiguous(), d.contiguous(), t_lo.contiguous(), t_hi.contiguous(), coherent=True
    )

    hit_p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]
    L = get_emission(bundle.bsdfs, hit.bsdf)
    frame0 = make_coord_space(hit.n)
    w_out0 = world_to_local(frame0, -d)
    Ld, st = direct_lighting(
        bundle, settings, tape[:, 4 : 4 + 2 * s], hit_p, hit.n, -d, hit.bsdf,
        active=_nee_active(bundle, hit.bsdf, hit.hit), counted=valid,
        frame=(frame0, w_out0),
    )
    L = L + Ld
    stats = stats + st
    if settings.indirect and settings.max_ray_depth > 1:
        Li, st = _indirect(
            bundle, settings, tape[:, 4 + 2 * s :], o, d, hit, valid=valid,
            frame=(frame0, w_out0),
        )
        L = L + Li
        stats = stats + st
    # a miss sees no environment in this slice: radiance 0
    L = torch.where(hit.hit[:, None], L, 0.0)
    return L, stats


def _indirect(bundle: SceneBundle, settings: RenderSettings, tape, o, d, hit, valid=None, frame=None):
    """Bounces 2+ of at_least_one_bounce_radiance (pathtracer.cpp:234-280).

    tape: (N, (D-1)*(4+2S)), one [rr 1 | bsdf 3 | NEE 2S] block per bounce.
    """
    n_lanes = o.shape[0]
    dev = o.device
    n_bounces = settings.max_ray_depth - 1
    per_bounce = tape.shape[1] // n_bounces
    tape_b = tape.reshape(n_lanes, n_bounces, per_bounce)
    if frame is None:
        o2w0 = make_coord_space(hit.n)
        frame = (o2w0, world_to_local(o2w0, -d))

    cur_o, cur_d, cur_hit = o, d, hit
    o2w, w_out = frame
    throughput = torch.ones((n_lanes, 3), device=dev)
    active = hit.hit
    L = torch.zeros((n_lanes, 3), device=dev)
    stats = torch.zeros(3, dtype=torch.float64, device=dev)
    for bounce in range(1, settings.max_ray_depth):
        u_b = tape_b[:, bounce - 1]
        depth_remaining = settings.max_ray_depth - (bounce - 1)
        cont = active & (depth_remaining > 1) & (u_b[:, 0] >= (1.0 - CPDF))

        bs = sample_f(bundle.bsdfs, cur_hit.bsdf, w_out, u_b[:, 1:4])
        cont = cont & bs.valid & (bs.pdf > 0)
        wi_world = local_to_world(o2w, bs.wi)
        safe_t = torch.where(cur_hit.hit, cur_hit.t, 0.0)
        hit_p = cur_o + cur_d * safe_t[:, None]
        b_o = _offset_origin(hit_p, cur_hit.n, wi_world)
        b_hi = torch.where(cont, 1e30, 0.0)
        nxt, st = trace_closest(
            bundle, b_o, wi_world, torch.full((n_lanes,), EPS_F, device=dev), b_hi
        )
        stats = stats + st
        cont = cont & nxt.hit

        cos_theta = torch.abs(bs.wi[:, 2]) / torch.clamp_min(norm3(bs.wi), 1e-30)
        step = bs.f * (cos_theta / (bs.pdf * CPDF))[:, None]
        throughput = torch.where(cont[:, None], throughput * step, throughput)
        # (the reference's emission pickup through delta lobes returns with
        # the mirror/glass families: no ported family is a delta lobe)

        nxt_p = hit_p + wi_world * nxt.t[:, None]
        o2w_n = make_coord_space(nxt.n)
        w_out_n = world_to_local(o2w_n, -wi_world)
        Ld, st = direct_lighting(
            bundle, settings, u_b[:, 4:], nxt_p, nxt.n, -wi_world, nxt.bsdf,
            active=_nee_active(bundle, nxt.bsdf, cont), counted=valid,
            frame=(o2w_n, w_out_n),
        )
        stats = stats + st
        L = L + torch.where(cont[:, None], throughput * Ld, 0.0)

        cur_o, cur_d, cur_hit, o2w, w_out, active = hit_p, wi_world, nxt, o2w_n, w_out_n, cont
    return L, stats


def pixel_keys(key, px, py, width):
    """Per-pixel base keys: fold_in(key, py * width + px) (path.py:881-882)."""
    return _rng.fold_in(key.expand(px.shape[0], 2), (py.to(torch.int64) * width + px) & _rng.MASK32)


def render_batch(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, s_offset: int, n_samples: int, valid=None):
    """Trace samples s_offset .. s_offset + n_samples - 1 for every lane (``path.py:829``).

    The building block of the Renderer's host-repacked adaptive render: the
    RNG depends only on (pixel id, sample index), so repacking the active
    pixels between calls changes no sample.  Returns (film sum (N, 3),
    s1 (N,), s2 (N,), stats [rays, tests, skipped]); the sums are float32.
    """
    n_px = px.shape[0]
    dev = px.device
    base_keys = pixel_keys(key, px, py, width)
    film = torch.zeros((n_px, 3), device=dev)
    s1 = torch.zeros(n_px, device=dev)
    s2 = torch.zeros(n_px, device=dev)
    stats = torch.zeros(3, dtype=torch.float64, device=dev)
    for j in range(n_samples):
        keys = _rng.fold_in(base_keys, s_offset + j)
        rad, st = radiance_sample(bundle, settings, cam, keys, px, py, width, height, valid=valid)
        illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
        film = film + rad
        s1 = s1 + illum
        s2 = s2 + illum * illum
        stats = stats + st
    return film, s1, s2, stats


def render_wavefront(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, valid=None):
    """Sampled radiance for a batch of pixels (raytrace_pixel).

    px, py: (P,) integer pixel coords on the bundle's device; key: (2,) RNG
    key.  Returns (radiance (P, 3), counts (P,), stats [rays, tests, skipped]).
    """
    n_px = px.shape[0]
    dev = px.device
    base_keys = pixel_keys(key, px, py, width)
    spb = min(settings.samples_per_batch, settings.ns_aa)
    n_batches = -(-settings.ns_aa // spb)
    adaptive = settings.ns_aa > spb

    film = torch.zeros((n_px, 3), device=dev)
    s1 = torch.zeros(n_px, device=dev)
    s2 = torch.zeros(n_px, device=dev)
    count = torch.zeros(n_px, dtype=torch.int32, device=dev)
    converged = torch.zeros(n_px, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.float64, device=dev)
    for b in range(n_batches if adaptive else 1):
        for j in range(spb):
            s_idx = b * spb + j
            keys = _rng.fold_in(base_keys, s_idx)
            rad, st = radiance_sample(bundle, settings, cam, keys, px, py, width, height, valid=valid)
            use = ~converged & (s_idx < settings.ns_aa)
            rad = torch.where(use[:, None], rad, 0.0)
            illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
            film = film + rad
            s1 = s1 + torch.where(use, illum, 0.0)
            s2 = s2 + torch.where(use, illum * illum, 0.0)
            count = count + use.to(torch.int32)
            stats = stats + st
        # 95% CI early stop (pathtracer.cpp:862-868)
        n = torch.clamp_min(count, 2).to(torch.float32)
        var = 1.0 / (n - 1.0) * torch.clamp_min(s2 - s1 * s1 / n, 0.0)
        ci = 1.96 * torch.sqrt(var) / torch.sqrt(n)
        converged = converged | (ci <= settings.max_tolerance * s1 / n)
    radiance = film / torch.clamp_min(count, 1)[:, None]
    return radiance, count, stats
