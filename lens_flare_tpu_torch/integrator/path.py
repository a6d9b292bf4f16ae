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
  of ``-H`` (``_hemisphere_rays``, ``:580-630``);
- the environment map looked up where a camera ray misses
  (``path.py:671-675``);
- Russian-roulette indirect bounces (``:704-826``) with the emission picked
  up through delta lobes, and no bounce sorting or compaction (both are off
  by default in the reference);
- per-pixel sample batches with the 95% CI stop (``render_wavefront``), and
  ``render_batch``, the building block of the Renderer's host-repacked
  adaptive render.

A sample is one loop over its path's vertices (``_vertex_loop``): the
closest-hit walk, the vertex's shading, the NEE rays' walk, the NEE gather.
On a CUDA device, for scenes of any BSDF families, triangles and spheres,
under directional, point, spot and area lights (``_takes_vertex_kernel``),
kernel I (``ops/csrc/shade.cu``) shades each vertex in two launches, in
place of the plain vertex functions' ~300 PyTorch ops; scenes with an
environment map, ``-H`` or other light types, a recorded gradient, and the
CPU run those plain functions (``_shade_plain``, ``_gather_plain``), which
kernel I matches bit for bit on the card.  :func:`vertex_routes` counts the
vertex wavefronts each route shaded.

Every BSDF family and light type of the JAX package is ported.  The
sample loops are Python loops; on a CUDA device the Renderer captures one
sample of a tile or chunk (``sampler``) as a CUDA graph (``compiled.py``)
and replays it per sample, so nothing a sample runs may copy from the host
or wait for the device.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import _rng
from ..ops.intersect import Hit, SceneArrays, finalize_hit
from ..ops.intersect_cuda import BVH_INF, KERNELS, BvhArrays, CudaScene, bvh_walk, walk_slots
from ..scene.build import LT_AREA, LT_DIRECTIONAL, LT_POINT, LT_SPOT
from ..scene.camera import CameraParams, generate_rays, generate_rays_bokeh, generate_rays_thin_lens
from ..scene.collada import BSDF_DIFFUSE, BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET, BSDF_REFRACTION
from .envlight import EnvLightArrays, sample_dir
from .lights import LightArrays, LightSample, sample_light_static
from .shading import (
    BSDFArrays,
    BSDFSample,
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


class _Walk(NamedTuple):
    """A closest-hit walk's outputs as the kernels leave them."""

    t: torch.Tensor  # (N,) distance; the walk's miss value where nothing was hit
    hit_id: torch.Tensor  # (N,) int32 slot (with smap), or primitive id (smap None: kernel G)
    smap: torch.Tensor | None  # slot -> primitive id
    found: torch.Tensor | None  # (N,) bool, or None: hit_id >= 0
    b1: torch.Tensor  # (N,) barycentrics (views of the walk's (N, 2) output on the cluster tree)
    b2: torch.Tensor
    tests: torch.Tensor  # (N,) int32
    rows: torch.Tensor | None  # (N, 10) kernel D's shading rows


def _walk_closest(bundle: SceneBundle, o, d, t_lo, t_hi, coherent=False) -> _Walk:
    """The closest-hit walk, routed as the JAX package's ``trace_closest`` (``path.py:279-305``).

    Binary-BVH scenes take kernel G; shade scenes take kernel D, whose
    shading rows replace the row gather, except for ``coherent`` (camera)
    wavefronts on stream scenes, which keep kernel A and the gather, as the
    reference does; every other scene takes kernel A.
    """
    cs = bundle.cscene
    if cs is None:
        t, prim, b1, b2, found, tests = bvh_walk(bundle.bvh, o, d, t_lo, t_hi)
        return _Walk(t, prim, None, found, b1, b2, tests, None)
    shade = cs.shade and not (coherent and cs.stream)
    t, slot, bary, tests, rows, smap = walk_slots(cs, o, d, t_lo, t_hi, return_shade=shade)
    return _Walk(t, slot, smap, None, bary[:, 0], bary[:, 1], tests, rows)


def _walk_any(bundle: SceneBundle, o, d, t_lo, t_hi):
    """The any-hit walk (kernel B, C on tiny scenes, G on binary-BVH ones): (slot, found, tests), the
    walk's occluder slot (-1: none) or, from kernel G, its bool ``found``; the other is None."""
    if bundle.cscene is None:
        _, _, _, _, found, tests = bvh_walk(bundle.bvh, o, d, t_lo, t_hi, any_hit=True)
        return None, found, tests
    _, slot, _, tests, _, _ = walk_slots(bundle.cscene, o, d, t_lo, t_hi, any_hit=True)
    return slot, None, tests


def trace_closest(bundle: SceneBundle, o, d, t_lo, t_hi, coherent=False):
    """Closest hit through :func:`_walk_closest`'s route, with shading normals and rows. Returns (Hit, stats).

    A miss returns t = 1e30 (``BVH_INF``) on every route.  Kernels A-D and
    their plain versions report a miss at 3e38, as the Pallas kernels do
    (``intersect_pallas.py:52``), and kernel G at 1e30, as the XLA walk
    does.  The JAX package's two routes differ in the same way; the port
    follows the XLA route, the one its tests run on the CPU.  The value
    matters: a bounce that misses still places its next vertex at
    ``hit_p + wi * t`` (the vertex loop), and that vertex's light sample
    decides whether its NEE lane is counted as skipped.

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
    w = _walk_closest(bundle, o, d, t_lo, t_hi, coherent)
    if w.smap is None:
        found, prim = w.found, w.hit_id
    else:
        found = w.hit_id >= 0
        prim = torch.where(found, w.smap[torch.clamp_min(w.hit_id, 0).long()], -1)
    t = torch.where(found, w.t, BVH_INF)
    hit = finalize_hit(scene, o, d, t, prim, w.b1, w.b2, found, shade_rows=w.rows)
    return _orient_normals(bundle, d, hit), _trace_stats(t_hi, w.tests)


def trace_occluded(bundle: SceneBundle, o, d, t_lo, t_hi):
    """Any-hit shadow query through :func:`_walk_any`. Returns (occluded, stats).

    The rays are detached, as in :func:`trace_closest`.
    """
    o, d, t_lo, t_hi = _detach(o, d, t_lo, t_hi)
    slot, found, tests = _walk_any(bundle, o, d, t_lo, t_hi)
    return (slot >= 0 if found is None else found), _trace_stats(t_hi, tests)


def tape_size(settings: RenderSettings) -> int:
    """Uniforms per (pixel, sample) lane: [jitter 2 | lens 2 | NEE 2S | per bounce: rr 1, bsdf 3, NEE 2S]."""
    s = max(settings.total_light_samples, 1)
    return 4 + 2 * s + max(settings.max_ray_depth - 1, 0) * (4 + 2 * s)


def _nee_active(bundle: SceneBundle, bsdf_id, hit_mask):
    """Lanes whose NEE estimate can be nonzero (see the reference's _nee_active)."""
    t = bundle.bsdfs.bsdf_type[bsdf_id.long()]
    return hit_mask & ((t == BSDF_DIFFUSE) | (t == BSDF_MICROFACET))


class _Nee(NamedTuple):
    """Next-event estimation at a vertex: its S*N rays, and what their walk's result is gathered with."""

    rays: tuple  # (o, d, t_lo, t_hi), slot-major: shadow rays, or ``-H``'s closest-hit rays
    value: torch.Tensor  # (S*N, 3) the contribution where unoccluded (``-H``: f)
    weight: torch.Tensor | None  # ``-H``: (S*N,) cos / pdf, applied after the emission hit
    live: torch.Tensor | None  # (S*N,) lanes that may contribute (shadow rays)
    skipped: torch.Tensor  # 0-d float64: NEE lanes that would trace but are provably zero
    n_pts: int


def direct_lighting(bundle: SceneBundle, settings: RenderSettings, u_tape, hit_p, n, w_out_w, bsdf_id, active=None, counted=None, frame=None):
    """NEE at a batch of shading points (pathtracer.cpp:142-213).

    All slots are traced as one widened shadow wavefront of S*N rays, each
    slot's light sampled from static row values (``light_slot_types``).
    ``-H`` takes the uniform-hemisphere estimator instead.  The vertex loop
    runs the same three steps (:func:`_nee_rays`, the walk, :func:`_nee_gather`).
    Returns ((N, 3) radiance, stats).
    """
    if frame is None:
        o2w = make_coord_space(n)
        frame = (o2w, world_to_local(o2w, w_out_w))
    nee = _nee_rays(bundle, settings, u_tape, hit_p, n, frame, bsdf_id, active, counted)
    if nee is None:
        return torch.zeros_like(hit_p), torch.zeros(3, dtype=torch.float64, device=hit_p.device)
    return _nee_gather(bundle, settings, nee, *_nee_walk(bundle, settings, nee))


def _nee_rays(bundle: SceneBundle, settings: RenderSettings, u_tape, hit_p, n, frame, bsdf_id, active, counted):
    """The first half of NEE: the S*N rays and the contributions they gate (None: no light slot)."""
    o2w, w_out = frame
    if settings.direct_hemisphere_sample:
        return _hemisphere_rays(bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id, active, counted)
    n_pts = hit_p.shape[0]
    n_slots = len(settings.light_slots)
    if n_slots == 0:
        return None

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
    # a missed vertex lies 1e30 away (trace_closest's miss distance), its
    # light sample's pdf may be 0, inf or NaN, and the masked forward is
    # finite, but a NaN factor turns the backward's zero cotangents into
    # NaN (0 * NaN)
    weight = torch.where(live, cos_theta / torch.clamp_min(ls_pdf, 1e-30), 0.0)
    contrib = torch.where(live[:, None], f, 0.0) * ls_rad * weight[:, None]
    rays = (
        _offset_origin(rep(hit_p), rep(n), ls_wi),
        ls_wi,
        torch.full((n_slots * n_pts,), EPS_F, device=hit_p.device),
        torch.where(live, ls_dist * (1.0 - 1e-3) - EPS_F, 0.0),
    )
    return _Nee(rays, contrib, None, live, skipped, n_pts)


def _hemisphere_rays(bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id, active, counted):
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
    f = eval_f(bundle.bsdfs, rep(bsdf_id), -wi, rep(w_out), families=settings.bsdf_families)
    rays = (
        rep(hit_p).contiguous(), wi_world.contiguous(),
        torch.full((num_samples * n_pts,), EPS_F, device=dev), t_hi.contiguous(),
    )
    return _Nee(rays, f, wi[:, 2] / (1.0 / (2.0 * math.pi)), None, skipped, n_pts)


def _nee_walk(bundle: SceneBundle, settings: RenderSettings, nee: _Nee):
    """The NEE rays' walk: (occluded, stats), or ``-H``'s (Hit, stats)."""
    if settings.direct_hemisphere_sample:
        return trace_closest(bundle, *nee.rays)
    return trace_occluded(bundle, *nee.rays)


def _nee_gather(bundle: SceneBundle, settings: RenderSettings, nee: _Nee, result, stats):
    """The second half of NEE: ((N, 3) radiance, stats) from the walk's ``result``."""
    stats = stats + torch.stack([torch.zeros_like(nee.skipped), torch.zeros_like(nee.skipped), nee.skipped])
    if nee.weight is not None:  # -H: the emission the closest hit found
        contrib = nee.value * get_emission(bundle.bsdfs, result.bsdf) * nee.weight[:, None]
        contrib = torch.where(result.hit[:, None], contrib, 0.0)
    else:
        use = nee.live & ~result
        contrib = torch.where(use[:, None], nee.value, 0.0)
    n_slots = contrib.shape[0] // nee.n_pts
    return contrib.view(n_slots, nee.n_pts, 3).sum(dim=0) / settings.total_light_samples, stats


# ---------------------------------------------------------------------------
# the vertex loop: walk -> shade (I-a) -> NEE walk -> gather (I-b), per vertex
# ---------------------------------------------------------------------------

VERTEX_MAX_SLOTS = 16  # kernel I's light slots (csrc/shade.cu MAX_SLOTS)
_KERNEL_LIGHTS = (LT_DIRECTIONAL, LT_POINT, LT_SPOT, LT_AREA)  # the light types kernel I samples


def vertex_routes() -> dict:
    """Vertex wavefronts shaded since the launch counts were reset: by kernel I ("kernel", an I-a and an I-b
    launch each) and by the plain vertex functions ("plain"); a replay adds what its capture counted."""
    return {"kernel": KERNELS["I"].launches // 2, "plain": KERNELS["I_plain"].launches}


def _takes_vertex_kernel(bundle: SceneBundle, settings: RenderSettings, o, d) -> bool:
    """Whether kernel I shades this sample's vertices, decided from the scene and the settings.

    It takes CUDA lanes of any BSDF families, on triangles and spheres, under
    directional, point, spot and area lights (at most ``VERTEX_MAX_SLOTS``
    slots), with the light-sample NEE (no ``-H``) and no environment map,
    while no gradient is recorded; everything else (the sky, ``-H``,
    hemisphere, sphere and mesh lights) runs the plain vertex functions.
    """
    if o.device.type != "cuda" or settings.direct_hemisphere_sample or bundle.env is not None:
        return False
    if len(settings.light_slots) > VERTEX_MAX_SLOTS:
        return False
    if any(code not in _KERNEL_LIGHTS for code in settings.light_slot_types):
        return False
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in (*bundle.bsdfs, *bundle.lights, o, d)))


def _general_vertex_kernel(bundle: SceneBundle, settings: RenderSettings) -> bool:
    """Whether kernel I-a runs its general instance: BSDF families beyond diffuse and emission (or
    unknown ones), spot or area slots, or spheres; else the instance that holds none of their code."""
    families = settings.bsdf_families
    return (families is None or not set(families) <= {BSDF_DIFFUSE, BSDF_EMISSION}
            or any(code in (LT_SPOT, LT_AREA) for code in settings.light_slot_types)
            or bundle.scene.sph_center.shape[0] > 0)


class _PlainPath(NamedTuple):
    """A path's state between the plain vertex functions."""

    hit0: torch.Tensor  # (N,) the camera ray hit
    L0: torch.Tensor  # (N, 3) the camera vertex's radiance: its emission, then + NEE
    stats: torch.Tensor  # float64 (3,) of the camera vertex
    L: torch.Tensor | None  # (N, 3) radiance gathered past the camera vertex (paths with bounces)
    stats_ind: torch.Tensor | None
    throughput: torch.Tensor | None
    alive: torch.Tensor  # (N,) the path reached this vertex
    hit: Hit  # this vertex's hit
    p: torch.Tensor | None  # (N, 3) its point (t where hit, else 0): the next bounce's base
    bs: BSDFSample | None  # the bounce sampled here
    bounce: torch.Tensor | None  # (N,) that bounce was traced
    wi: torch.Tensor | None  # (N, 3) its direction in world space


def _shade_plain(bundle: SceneBundle, settings: RenderSettings, tape, k, n_vertices, walked, ray, path, valid):
    """Vertex ``k`` from the walk's (Hit, stats): the path steps on, the NEE rays and the next bounce's
    ray (None after the last vertex).  The plain twin of kernel I's ``lf_shade_vertex``."""
    hit, st = walked
    bsdfs = bundle.bsdfs
    s = max(settings.total_light_samples, 1)
    block = 4 + 2 * s  # a bounce's tape: [rr 1 | bsdf 3 | NEE 2S]
    if k == 0:
        dirn = ray[1]
        p = ray[0] + dirn * torch.where(hit.hit, hit.t, 0.0)[:, None]
        p_nee, u_nee = p, tape[:, 4 : 4 + 2 * s]
        bounces = n_vertices > 1
        path = _PlainPath(
            hit0=hit.hit, L0=get_emission(bsdfs, hit.bsdf), stats=st,
            L=torch.zeros_like(p) if bounces else None,
            stats_ind=torch.zeros(3, dtype=torch.float64, device=p.device) if bounces else None,
            throughput=torch.ones_like(p) if bounces else None,
            alive=hit.hit, hit=hit, p=p, bs=None, bounce=None, wi=None,
        )
    else:
        base, dirn, bs = path.p, path.wi, path.bs
        alive = path.bounce & hit.hit
        cos_theta = torch.abs(bs.wi[:, 2]) / torch.clamp_min(norm3(bs.wi), 1e-30)
        step = bs.f * (cos_theta / (bs.pdf * CPDF))[:, None]
        throughput = torch.where(alive[:, None], path.throughput * step, path.throughput)
        # emission seen through a delta lobe (mirror, refraction, glass):
        # NEE cannot sample such a path, so the emitter it hits is added
        # here, for delta chains only (``path.py:792-802``)
        emit = get_emission(bsdfs, hit.bsdf)
        L = path.L + torch.where((alive & is_delta(bsdfs, path.hit.bsdf))[:, None], throughput * emit, 0.0)
        p_nee = base + dirn * hit.t[:, None]  # a missed bounce's vertex lies 1e30 away
        p = base + dirn * torch.where(hit.hit, hit.t, 0.0)[:, None] if k < n_vertices - 1 else None
        off = 4 + 2 * s + (k - 1) * block
        u_nee = tape[:, off + 4 : off + block]
        path = path._replace(
            alive=alive, hit=hit, p=p, throughput=throughput, L=L, stats_ind=path.stats_ind + st,
        )
    o2w = make_coord_space(hit.n)
    w_out = world_to_local(o2w, -dirn)
    nee = _nee_rays(
        bundle, settings, u_nee, p_nee, hit.n, (o2w, w_out), hit.bsdf,
        active=_nee_active(bundle, hit.bsdf, path.alive), counted=valid,
    )
    if k == n_vertices - 1:
        return path, nee, None
    # Russian roulette and the BSDF sample (pathtracer.cpp:234-280)
    off = 4 + 2 * s + k * block
    u_b = tape[:, off : off + 4]
    bounce = path.alive & (u_b[:, 0] >= (1.0 - CPDF))
    bs = sample_f(bsdfs, hit.bsdf, w_out, u_b[:, 1:4], families=settings.bsdf_families)
    bounce = bounce & bs.valid & (bs.pdf > 0)
    wi = local_to_world(o2w, bs.wi)
    b_hi = torch.where(bounce, 1e30, 0.0)
    ray = (_offset_origin(path.p, hit.n, wi), wi, torch.full((wi.shape[0],), EPS_F, device=wi.device), b_hi)
    return path._replace(bs=bs, bounce=bounce, wi=wi), nee, ray


def _gather_plain(bundle: SceneBundle, settings: RenderSettings, k, path: _PlainPath, nee, walked):
    """Vertex ``k``'s NEE from its walk, added to the path.  The plain twin of ``lf_gather_vertex``."""
    if nee is None:
        Ld, st = torch.zeros_like(path.L0), torch.zeros(3, dtype=torch.float64, device=path.L0.device)
    else:
        Ld, st = _nee_gather(bundle, settings, nee, *walked)
    if k == 0:
        return path._replace(L0=path.L0 + Ld, stats=path.stats + st)
    return path._replace(
        stats_ind=path.stats_ind + st, L=path.L + torch.where(path.alive[:, None], path.throughput * Ld, 0.0)
    )


def _finish_plain(bundle: SceneBundle, path: _PlainPath, d):
    L, stats = path.L0, path.stats
    if path.L is not None:
        L = L + path.L
        stats = stats + path.stats_ind
    # a camera ray that misses sees the environment (pathtracer.cpp:290-292);
    # padding lanes (t_hi = 0) miss too, and their radiance is discarded
    L_miss = sample_dir(bundle.env, d) if bundle.env is not None else 0.0
    return torch.where(path.hit0[:, None], L, L_miss), stats


# the tables only I-a's general instance reads, in ShadeArgs' order
_GENERAL_TABLES = ("reflectance", "transmittance", "eta", "k", "alpha", "ior", "light_dim_x", "light_dim_y",
                   "light_area", "sph_center", "sph_bsdf")


class _ShadeArgs(ctypes.Structure):
    """``ShadeArgs`` of ``csrc/shade.cu``: the same fields in the same order."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "t", "hit_id", "smap", "found", "b1", "b2", "tests", "rows", "base", "org", "dir", "ray_thi", "tape",
            "valid", "tri_shade", "bsdf_type", "albedo", "emit", "light_rad", "light_pos", "light_dir",
            *_GENERAL_TABLES, "fstate", "istate", "so", "sd", "stlo", "sthi", "contrib", "bo", "bd", "btlo", "bthi",
            "pb",
        )
    ] + [(name, ctypes.c_longlong) for name in ("n", "tape_u", "bstride")] + [
        (name, ctypes.c_int)
        for name in ("num_tris", "n_sph", "vertex", "sample_bounce", "s_tape", "emission_family", "general", "n_slots")
    ] + [("slot_row", ctypes.c_int * VERTEX_MAX_SLOTS), ("slot_code", ctypes.c_int * VERTEX_MAX_SLOTS)]


class _GatherArgs(ctypes.Structure):
    """``GatherArgs`` of ``csrc/shade.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("contrib", "occ_slot", "occ_found", "occ_tests", "fstate", "istate", "radiance")
    ] + [("n", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("vertex", "last", "indirect", "n_slots")
    ] + [("inv_total", ctypes.c_float)]


class _KernelPath(NamedTuple):
    """A path's state on kernel I's route: lane buffers of one sample, updated in place."""

    fstate: torch.Tensor  # (N, 12) float32 [L0 | L indirect | throughput | pending step]
    istate: torch.Tensor  # (N, 4) int32 [rays | tests | skipped | flags]
    pb: torch.Tensor  # (N, 3) this vertex's point: the next one's base
    bounce: tuple  # (o, d, t_lo, t_hi) of the bounce ray, (N, 3) and (N,)
    shadow: tuple  # (o, d, t_lo, t_hi) of the S*N shadow rays
    contrib: torch.Tensor  # (S*N, 3)
    radiance: torch.Tensor  # (N, 3)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_lanes(dev, *arrays):
    """Each (name, tensor, shape, dtype): contiguous, of that shape and dtype, on ``dev``."""
    for name, x, shape, dtype in arrays:
        if x is None:
            continue
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: want a contiguous {dtype} {tuple(shape)} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_vertex(symbol: str, args, dev) -> None:
    from ..ops._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):  # the lanes' device and its current stream: a shard's, on a mesh
        rc = getattr(lib, symbol)(ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {symbol} failed to launch: cudaError {rc}")
    KERNELS["I"].launches += 1


def _shade_kernel(bundle: SceneBundle, settings: RenderSettings, tape, k, n_vertices, w: _Walk, ray, path, valid):
    """Kernel I-a (``lf_shade_vertex``) on vertex ``k``'s walk: see :func:`_shade_plain`."""
    n, dev = tape.shape[0], tape.device
    n_slots = len(settings.light_slots)
    if k == 0:
        def lanes(m, *shape):
            return torch.empty((m, *shape), device=dev)

        path = _KernelPath(
            lanes(n, 12), torch.empty((n, 4), dtype=torch.int32, device=dev), lanes(n, 3),
            (lanes(n, 3), lanes(n, 3), lanes(n), lanes(n)),
            (lanes(n_slots * n, 3), lanes(n_slots * n, 3), lanes(n_slots * n), lanes(n_slots * n)),
            lanes(n_slots * n, 3), lanes(n, 3),
        )
        base, org, dirn, thi = ray[0], ray[0], ray[1], ray[3]
    else:
        base, org, dirn, thi = path.pb, path.bounce[0], path.bounce[1], path.bounce[3]
    bsdfs, lights, scene = bundle.bsdfs, bundle.lights, bundle.scene
    n_lights, n_tris, n_bsdfs = lights.light_type.shape[0], scene.tri_shade.shape[0], bsdfs.bsdf_type.shape[0]
    n_sph = scene.sph_center.shape[0]
    general = _general_vertex_kernel(bundle, settings)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    tables = ((bsdfs.reflectance, bsdfs.transmittance, bsdfs.eta, bsdfs.k, bsdfs.alpha, bsdfs.ior, lights.dim_x,
               lights.dim_y, lights.area, scene.sph_center, scene.sph_bsdf) if general else (None,) * 11)
    shapes = ((n_bsdfs, 3),) * 4 + ((n_bsdfs,),) * 2 + ((n_lights, 3),) * 2 + ((n_lights,), (n_sph, 3), (n_sph,))
    _check_lanes(
        dev, ("t", w.t, (n,), f32), ("hit_id", w.hit_id, (n,), i32), ("found", w.found, (n,), u8),
        ("tests", w.tests, (n,), i32), ("rows", w.rows, (n, 10), f32), ("base", base, (n, 3), f32),
        ("org", org, (n, 3), f32), ("dir", dirn, (n, 3), f32), ("t_hi", thi, (n,), f32), ("valid", valid, (n,), u8),
        ("tape", tape, (n, tape_size(settings)), f32), ("tri_shade", scene.tri_shade, (n_tris, 10), f32),
        ("bsdf_type", bsdfs.bsdf_type, bsdfs.bsdf_type.shape, i32),
        ("albedo", bsdfs.albedo, (n_bsdfs, 3), f32), ("radiance", bsdfs.radiance, (n_bsdfs, 3), f32),
        *((name, getattr(lights, name), (n_lights, 3), f32) for name in ("radiance", "position", "direction")),
        *((name, x, shape, i32 if name == "sph_bsdf" else f32)
          for name, x, shape in zip(_GENERAL_TABLES, tables, shapes)),
    )
    bstride = w.b1.stride(0)
    if w.b1.dtype != f32 or w.b2.stride(0) != bstride or w.b1.shape != (n,) or w.b1.device != dev:
        raise ValueError("b1, b2: want float32 (N,) lanes of one stride")
    if w.smap is not None and (w.smap.dtype != i32 or not w.smap.is_contiguous()):
        raise ValueError("smap: want contiguous int32")
    if any(not 0 <= row < n_lights for row in settings.light_slots):
        raise ValueError(f"light slots {settings.light_slots} past the table's {n_lights} rows")
    if any(code not in _KERNEL_LIGHTS for code in settings.light_slot_types):
        raise ValueError(f"light slot types {settings.light_slot_types}: kernel I samples only {_KERNEL_LIGHTS}")
    bo, bd, btlo, bthi = path.bounce
    so, sd, stlo, sthi = path.shadow
    args = _ShadeArgs(
        *map(_ptr, (w.t, w.hit_id, w.smap, w.found, w.b1, w.b2, w.tests, w.rows, base, org, dirn, thi, tape, valid,
                    scene.tri_shade, bsdfs.bsdf_type, bsdfs.albedo, bsdfs.radiance, lights.radiance,
                    lights.position, lights.direction, *tables, path.fstate, path.istate, so, sd, stlo, sthi,
                    path.contrib, bo, bd, btlo, bthi, path.pb)),
        n, tape.shape[1], bstride, n_tris, n_sph, k, int(k < n_vertices - 1), max(settings.total_light_samples, 1),
        int(settings.bsdf_families is None or BSDF_EMISSION in settings.bsdf_families), int(general), n_slots,
        (ctypes.c_int * VERTEX_MAX_SLOTS)(*settings.light_slots),
        (ctypes.c_int * VERTEX_MAX_SLOTS)(*settings.light_slot_types),
    )
    _launch_vertex("lf_shade_vertex", args, dev)
    return path, (path.shadow if n_slots else None), (path.bounce if k < n_vertices - 1 else None)


def _gather_kernel(settings: RenderSettings, k, path: _KernelPath, nee, walked, n_vertices):
    """Kernel I-b (``lf_gather_vertex``) after vertex ``k``'s shadow walk: see :func:`_gather_plain`."""
    n = path.fstate.shape[0]
    n_slots = len(settings.light_slots) if nee is not None else 0
    slot, found, tests = walked if nee is not None else (None, None, None)
    _check_lanes(
        path.fstate.device, ("occluder", slot, (n_slots * n,), torch.int32),
        ("occluded", found, (n_slots * n,), torch.bool), ("tests", tests, (n_slots * n,), torch.int32),
    )
    # torch's x / total on the card multiplies by the float reciprocal (div_true_kernel_cuda)
    inv_total = float(np.float32(1.0) / np.float32(settings.total_light_samples))
    args = _GatherArgs(
        *map(_ptr, (path.contrib, slot, found, tests, path.fstate, path.istate, path.radiance)),
        n, k, int(k == n_vertices - 1), int(n_vertices > 1), n_slots, inv_total,
    )
    _launch_vertex("lf_gather_vertex", args, path.fstate.device)
    return path


def _vertex_loop(bundle: SceneBundle, settings: RenderSettings, tape, ray, d, valid):
    """The path's vertices, each walk -> shade -> NEE walk -> gather, by kernel I or the plain functions.

    ``ray``: the camera rays (o, d, t_lo, t_hi), contiguous; ``d`` the
    camera directions the environment is looked up with.  Returns ((N, 3)
    radiance, stats [rays, tests, skipped]).
    """
    n_vertices = settings.max_ray_depth if settings.indirect and settings.max_ray_depth > 1 else 1
    kernel = _takes_vertex_kernel(bundle, settings, ray[0], ray[1])
    if not kernel:
        KERNELS["I_plain"].launches += n_vertices
    path = None
    for k in range(n_vertices):
        if kernel:
            walked = _walk_closest(bundle, *ray, coherent=k == 0)
            path, nee, ray = _shade_kernel(bundle, settings, tape, k, n_vertices, walked, ray, path, valid)
            path = _gather_kernel(settings, k, path, nee, _walk_any(bundle, *nee) if nee else None, n_vertices)
        else:
            walked = trace_closest(bundle, *ray, coherent=k == 0)
            path, nee, ray = _shade_plain(bundle, settings, tape, k, n_vertices, walked, ray, path, valid)
            path = _gather_plain(bundle, settings, k, path, nee, _nee_walk(bundle, settings, nee) if nee else None)
    if kernel:
        return path.radiance, path.istate[:, :3].sum(dim=0, dtype=torch.float64)
    return _finish_plain(bundle, path, d)


def radiance_sample(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, keys, px, py, width, height, valid=None):
    """One radiance sample per pixel lane (est_radiance_global_illumination).

    keys: (N, 2) per-lane RNG keys; valid: optional (N,) bool, False for
    shape padding (t_hi = 0: traces nothing, counts nothing).
    Returns ((N, 3) radiance, stats [rays, tests, skipped]).
    """
    n_lanes = px.shape[0]
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
    ray = (o.contiguous(), d.contiguous(), t_lo.contiguous(), t_hi.contiguous())
    return _vertex_loop(bundle, settings, tape, ray, d, valid)


def pixel_keys(key, px, py, width):
    """Per-pixel base keys: fold_in(key, py * width + px) (path.py:881-882)."""
    return _rng.fold_in(key.expand(px.shape[0], 2), (py.to(torch.int64) * width + px) & _rng.MASK32)


def sampler(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, valid=None):
    """``sample(s_idx) -> (radiance (P, 3), stats)``: sample ``s_idx`` (a 0-d
    integer tensor on the lanes' device) of every lane, whose keys are the
    pixel keys folded with it.  The unit the sample loops of
    ``render_wavefront`` and ``render_batch`` call; a Renderer on a CUDA
    device passes its captured counterpart (``Renderer._sampler``).
    """
    base_keys = pixel_keys(key, px, py, width)
    return lambda s_idx: radiance_sample(
        bundle, settings, cam, _rng.fold_in(base_keys, s_idx), px, py, width, height, valid=valid
    )


def render_batch(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, s_offset, n_samples: int, valid=None, sample=None):
    """Trace samples s_offset .. s_offset + n_samples - 1 for every lane (``path.py:829``).

    The building block of the Renderer's host-repacked adaptive render: the
    RNG depends only on (pixel id, sample index), so repacking the active
    pixels between calls changes no sample.  ``s_offset``: an int, or a 0-d
    integer tensor on the lanes' device (the JAX package passes a traced
    uint32).  ``sample``: see :func:`sampler`, which it defaults to.
    Returns (film sum (N, 3), s1 (N,), s2 (N,), stats [rays, tests,
    skipped]); the sums are float32.
    """
    n_px = px.shape[0]
    dev = px.device
    if sample is None:
        sample = sampler(bundle, settings, cam, px, py, width, height, key, valid)
    film = torch.zeros((n_px, 3), device=dev)
    s1 = torch.zeros(n_px, device=dev)
    s2 = torch.zeros(n_px, device=dev)
    stats = torch.zeros(3, dtype=torch.float64, device=dev)
    samples = s_offset + torch.arange(n_samples, dtype=torch.int64, device=dev)
    for j in range(n_samples):
        rad, st = sample(samples[j])
        illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
        film = film + rad
        s1 = s1 + illum
        s2 = s2 + illum * illum
        stats = stats + st
    return film, s1, s2, stats


def render_wavefront(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, valid=None, sample=None):
    """Sampled radiance for a batch of pixels (raytrace_pixel).

    px, py: (P,) integer pixel coords on the bundle's device; key: (2,) RNG
    key; ``sample``: see :func:`sampler`, which it defaults to.  Returns
    (radiance (P, 3), counts (P,), stats [rays, tests, skipped]).
    """
    n_px = px.shape[0]
    dev = px.device
    if sample is None:
        sample = sampler(bundle, settings, cam, px, py, width, height, key, valid)
    spb = min(settings.samples_per_batch, settings.ns_aa)
    n_batches = -(-settings.ns_aa // spb)
    adaptive = settings.ns_aa > spb

    film = torch.zeros((n_px, 3), device=dev)
    s1 = torch.zeros(n_px, device=dev)
    s2 = torch.zeros(n_px, device=dev)
    count = torch.zeros(n_px, dtype=torch.int32, device=dev)
    converged = torch.zeros(n_px, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.float64, device=dev)
    samples = torch.arange(n_batches * spb, dtype=torch.int64, device=dev)
    for b in range(n_batches if adaptive else 1):
        for j in range(spb):
            s_idx = b * spb + j
            rad, st = sample(samples[s_idx])
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
