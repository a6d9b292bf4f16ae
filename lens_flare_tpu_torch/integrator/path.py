"""Wavefront path-tracing integrator.

Counterpart of ``lens_flare_tpu/integrator/path.py``, computing the same
estimator on the same random numbers (``_rng`` reproduces the threefry
tape lane for lane):

- pinhole, thin-lens and bokeh-mask camera rays, the closest-hit trace
  (kernel D with its shading rows on shade scenes, else kernel A and the row
  gather; kernel G and the row gather on binary-BVH scenes) and hit
  finalization, with face-forward normals except on transmissive BSDFs;
- next-event estimation over the static light-slot plan, the environment
  light's slots included, one widened any-hit shadow wavefront per vertex
  (``direct_lighting``, ``:430-577``), or the uniform-hemisphere estimator
  of ``-H`` (``_direct_hemisphere``, ``:580-630``);
- the environment map looked up where a camera ray misses
  (``path.py:671-675``);
- Russian-roulette indirect bounces (``_indirect``, ``:704-826``) with the
  emission picked up through delta lobes, and no bounce sorting or
  compaction (both are off by default in the reference);
- per-pixel sample batches with the 95% CI stop (``render_wavefront``), and
  ``render_batch``, the building block of the Renderer's host-repacked
  adaptive render.

Every BSDF family and light type of the JAX package is ported.  PyTorch
runs eagerly: the bounce ``scan`` and the sample loops are Python loops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import _rng
from ..ops.intersect import SceneArrays, finalize_hit
from ..ops.intersect_cuda import BvhArrays, CudaScene, bvh_walk, intersect
from ..scene.camera import CameraParams, generate_rays, generate_rays_bokeh, generate_rays_thin_lens
from ..scene.collada import BSDF_DIFFUSE, BSDF_GLASS, BSDF_MICROFACET, BSDF_REFRACTION
from .envlight import EnvLightArrays, sample_dir
from .lights import LightArrays, LightSample, sample_light_static
from .shading import (
    BSDFArrays,
    eval_f,
    get_emission,
    is_delta,
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
    """Integrator knobs (the reference's CLI surface, main.cpp:24-39)."""

    ns_aa: int = 1  # -s
    max_ray_depth: int = 1  # -m
    ns_area_light: int = 1  # -l
    samples_per_batch: int = 64  # -a
    max_tolerance: float = 0.05  # -a
    direct_hemisphere_sample: bool = False  # -H
    indirect: bool = True
    use_thin_lens: bool = False  # thin-lens camera (bokeh mask when the bundle has one)
    light_slots: tuple = ()  # light row per NEE slot
    light_slot_types: tuple = ()  # LT_* code per NEE slot
    total_light_samples: int = 1
    # the LT_* and BSDF_* codes in the scene's tables (None: every family);
    # BSDF families absent from the scene are left out of the shading math
    light_types: tuple | None = None
    bsdf_families: tuple | None = None


def make_settings(light_table, ns_aa=1, max_ray_depth=1, ns_area_light=1, bsdf_table=None, **kw) -> RenderSettings:
    """Settings with the static NEE slot plan from the host light table (``path.py:123-163``).

    The scene's light types and BSDF families specialize the sampling; a
    caller's stale ``light_types`` or ``bsdf_families`` that misses a code in
    the tables raises a ValueError.  An environment-light row is not delta,
    so it gets ``ns_area_light`` slots.
    """
    slots = []
    for li in range(len(light_table.light_type)):
        slots.extend([li] * (1 if light_table.is_delta[li] else ns_area_light))
    kw.setdefault("light_types", tuple(sorted({int(t) for t in light_table.light_type})))
    if bsdf_table is not None:
        kw.setdefault("bsdf_families", tuple(sorted({int(t) for t in bsdf_table.bsdf_type})))
    settings = RenderSettings(
        ns_aa=ns_aa,
        max_ray_depth=max_ray_depth,
        ns_area_light=ns_area_light,
        light_slots=tuple(slots),
        light_slot_types=tuple(int(light_table.light_type[li]) for li in slots),
        total_light_samples=max(len(slots), 1),
        **kw,
    )
    if settings.light_types is not None:
        missing = {int(t) for t in light_table.light_type} - set(settings.light_types)
        if missing:
            raise ValueError(f"light_types {settings.light_types} misses scene light codes {sorted(missing)}")
    if bsdf_table is not None and settings.bsdf_families is not None:
        missing = {int(t) for t in bsdf_table.bsdf_type} - set(settings.bsdf_families)
        if missing:
            raise ValueError(f"bsdf_families {settings.bsdf_families} misses scene BSDF codes {sorted(missing)}")
    return settings


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
    cscene: CudaScene | None  # cluster tree for kernels A-D (None: the binary BVH)
    bokeh: BokehMask | None = None  # aperture-shaped depth of field
    bvh: BvhArrays | None = None  # binary BVH for kernel G, when there is no cluster tree
    env: EnvLightArrays | None = None  # environment map: LT_ENV rows and the camera-miss lookup


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


def _detach(*tensors):
    """The tensors cut from the autograd graph (``path.py:244-246``)."""
    return tuple(t.detach() for t in tensors)


def _orient_normals(bundle: SceneBundle, d, hit):
    """Face-forward shading normals, except on refraction and glass (``path.py:342-358``).

    A backfacing normal is flipped toward the ray; transmissive BSDFs keep
    the raw normal, whose side tells entering from exiting.
    """
    t = bundle.bsdfs.bsdf_type[hit.bsdf.long()]
    transmissive = (t == BSDF_REFRACTION) | (t == BSDF_GLASS)
    backface = (hit.n[:, 0] * d[:, 0] + hit.n[:, 1] * d[:, 1] + hit.n[:, 2] * d[:, 2]) > 0
    flip = backface & ~transmissive & hit.hit
    return hit._replace(n=torch.where(flip[:, None], -hit.n, hit.n))


def trace_closest(bundle: SceneBundle, o, d, t_lo, t_hi, coherent=False):
    """Closest hit, routed as the JAX package's ``trace_closest`` (``path.py:279-305``).

    Binary-BVH scenes take kernel G and the row gather, as the JAX package's
    XLA walk.  Shade scenes take kernel D, whose shading rows replace the
    row gather, except for ``coherent`` (camera) wavefronts on stream scenes
    with ``stream_shade``, which keep kernel A and the gather, as the
    reference does.  Every other scene takes kernel A (C's closest hit is
    forced only by tests).  Returns (Hit, stats).

    Differentiability contract, as the JAX package's (``path.py:262-276``):
    the trace is a visibility oracle with no gradient.  ``o``, ``d``,
    ``t_lo``, ``t_hi`` and the shading tables are detached before the
    kernels (or their plain versions, whose loops would otherwise record a
    graph) and ``finalize_hit``, so the hit (t, prim, barycentrics, normal,
    bsdf row) is a constant of the backward pass.  Autograd of a rendered
    pixel flows through the shading chain only: emitter radiance, albedos
    and light radiance get the exact gradient of the fixed-RNG estimator,
    whose discrete hit structure is piecewise constant in them
    (``tests/test_torch_diff.py`` checks it by central differences).  The
    cluster tree and the binary BVH are built from NumPy and never
    require a gradient.
    """
    o, d, t_lo, t_hi = _detach(o, d, t_lo, t_hi)
    scene = SceneArrays(*_detach(*bundle.scene))
    cs = bundle.cscene
    if cs is None:
        t, prim, b1, b2, found, tests = bvh_walk(bundle.bvh, o, d, t_lo, t_hi)
        hit = finalize_hit(scene, o, d, t, prim, b1, b2, found)
    elif cs.shade and not (coherent and cs.stream):
        t, prim, b1, b2, found, tests, rows = intersect(cs, o, d, t_lo, t_hi, return_shade=True)
        hit = finalize_hit(scene, o, d, t, prim, b1, b2, found, shade_rows=rows)
    else:
        t, prim, b1, b2, found, tests = intersect(cs, o, d, t_lo, t_hi)
        hit = finalize_hit(scene, o, d, t, prim, b1, b2, found)
    return _orient_normals(bundle, d, hit), _trace_stats(t_hi, tests)


def trace_occluded(bundle: SceneBundle, o, d, t_lo, t_hi):
    """Any-hit shadow query through kernel B (C on tiny scenes, G on binary-BVH ones). Returns (occluded, stats).

    The rays are detached, as in :func:`trace_closest`.
    """
    o, d, t_lo, t_hi = _detach(o, d, t_lo, t_hi)
    if bundle.cscene is None:
        _, _, _, _, found, tests = bvh_walk(bundle.bvh, o, d, t_lo, t_hi, any_hit=True)
    else:
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
    """NEE at a batch of shading points (pathtracer.cpp:142-213).

    All slots are traced as one widened shadow wavefront of S*N rays, each
    slot's light sampled from static row values (``light_slot_types``).
    ``-H`` takes the uniform-hemisphere estimator instead.  Returns
    ((N, 3) radiance, stats).
    """
    if frame is not None:
        o2w, w_out = frame
    else:
        o2w = make_coord_space(n)
        w_out = world_to_local(o2w, w_out_w)
    if settings.direct_hemisphere_sample:
        return _direct_hemisphere(bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id, active=active, counted=counted)
    n_pts = hit_p.shape[0]
    n_slots = len(settings.light_slots)
    if n_slots == 0:
        return torch.zeros_like(hit_p), torch.zeros(3, dtype=torch.float64, device=hit_p.device)

    def rep(x):
        return x.repeat((n_slots,) + (1,) * (x.dim() - 1))

    parts = [
        sample_light_static(bundle.lights, row, code, hit_p, u_tape[:, 2 * s : 2 * s + 2], env=bundle.env)
        for s, (row, code) in enumerate(zip(settings.light_slots, settings.light_slot_types))
    ]
    ls_rad, ls_wi, ls_dist, ls_pdf = (torch.cat([getattr(x, f) for x in parts]) for f in LightSample._fields)

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
    f = eval_f(bundle.bsdfs, rep(bsdf_id), -wi_obj, rep(w_out), families=settings.bsdf_families)
    # lanes that are not live get factors of 0, live lanes the same values:
    # a missed vertex lies ~3e38 away (the kernels' miss distance), its light
    # sample's pdf is NaN, and the masked forward is finite, but a NaN factor
    # turns the backward's zero cotangents into NaN (0 * NaN)
    weight = torch.where(live, cos_theta / torch.clamp_min(ls_pdf, 1e-30), 0.0)
    contrib = torch.where(live[:, None], f, 0.0) * ls_rad * weight[:, None]

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


def _direct_hemisphere(bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id, active=None, counted=None):
    """Uniform-hemisphere direct estimator of ``-H`` (pathtracer.cpp:86-140, ``path.py:580-630``).

    Each of the S samples traces a closest-hit ray from the shading point
    (no origin offset, as the reference) and picks up the emission it hits.
    """
    num_samples = settings.total_light_samples
    n_pts = hit_p.shape[0]
    dev = hit_p.device

    def rep(x):
        return x.repeat((num_samples,) + (1,) * (x.dim() - 1))

    u = u_tape.reshape(n_pts, num_samples, 2).transpose(0, 1).reshape(-1, 2)  # (S*N, 2)
    theta = torch.arccos(torch.clamp(u[:, 0], -1.0, 1.0))
    phi = 2.0 * math.pi * u[:, 1]
    wi = torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)], dim=-1
    )
    wi_world = local_to_world(rep(o2w), wi)
    skipped = torch.zeros((), dtype=torch.float64, device=dev)
    real = rep(counted) if counted is not None else None
    if active is not None:
        live = rep(active)
        if real is not None:
            live = live & real
            skipped = (real & ~live).sum(dtype=torch.float64)
        else:
            skipped = (~live).sum(dtype=torch.float64)
        t_hi = torch.where(live, 1e30, 0.0)
    elif real is not None:
        t_hi = torch.where(real, 1e30, 0.0)
    else:
        t_hi = torch.full((num_samples * n_pts,), 1e30, device=dev)
    hit, stats = trace_closest(
        bundle, rep(hit_p).contiguous(), wi_world.contiguous(),
        torch.full((num_samples * n_pts,), EPS_F, device=dev), t_hi.contiguous(),
    )
    stats = stats + torch.stack([torch.zeros_like(skipped), torch.zeros_like(skipped), skipped])
    emission = get_emission(bundle.bsdfs, hit.bsdf)
    f = eval_f(bundle.bsdfs, rep(bsdf_id), -wi, rep(w_out), families=settings.bsdf_families)
    contrib = f * emission * (wi[:, 2] / (1.0 / (2.0 * math.pi)))[:, None]
    contrib = torch.where(hit.hit[:, None], contrib, 0.0)
    return contrib.view(num_samples, n_pts, 3).sum(dim=0) / num_samples, stats


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
    # a camera ray that misses sees the environment (pathtracer.cpp:290-292);
    # padding lanes (t_hi = 0) miss too, and their radiance is discarded
    L_miss = sample_dir(bundle.env, d) if bundle.env is not None else 0.0
    L = torch.where(hit.hit[:, None], L, L_miss)
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

        bs = sample_f(bundle.bsdfs, cur_hit.bsdf, w_out, u_b[:, 1:4], families=settings.bsdf_families)
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
        # emission seen through a delta lobe (mirror, refraction, glass):
        # NEE cannot sample such a path, so the emitter it hits is added
        # here, for delta chains only (``path.py:792-802``)
        emit = get_emission(bundle.bsdfs, nxt.bsdf)
        L = L + torch.where((cont & is_delta(bundle.bsdfs, cur_hit.bsdf))[:, None], throughput * emit, 0.0)

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
