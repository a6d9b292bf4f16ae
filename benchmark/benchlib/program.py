"""The system under test: ``lens_flare_tpu_torch``, handed the benchmark's inputs.

Everything the harness takes from the program goes through here: the
renderer built from a configuration, the terrain given to it as its
``FlatScene``, its captured programs' seconds, and its trace kernels timed
alone on the cell's own wavefronts for the roofline share.  Imported only
once a run has found its card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import roofline
from .scene import Terrain, mask


def flat_scene(t: Terrain):
    """The program's ``FlatScene`` holding the benchmark's terrain arrays."""
    from lens_flare_tpu_torch.scene.build import BSDFTable, FlatScene, LightTable
    from lens_flare_tpu_torch.scene.collada import MaterialInfo

    n_l = len(t.light_type)
    lights = LightTable(
        light_type=t.light_type.copy(), radiance=t.light_radiance.copy(), position=t.light_position.copy(),
        direction=t.light_direction.copy(), dim_x=np.zeros((n_l, 3), np.float32),
        dim_y=np.zeros((n_l, 3), np.float32), area=np.zeros(n_l, np.float32), is_delta=np.ones(n_l, bool),
    )
    scene = FlatScene(
        tri_p=t.tri_p, tri_n=t.tri_n, tri_bsdf=np.zeros(t.num_triangles, np.int32),
        sph_center=np.zeros((0, 3), np.float32), sph_radius=np.zeros(0, np.float32),
        sph_bsdf=np.zeros(0, np.int32),
        bsdfs=BSDFTable.from_materials([MaterialInfo(albedo=t.albedo.astype(np.float64))]), lights=lights,
    )
    scene.bbox_min = t.bbox_min.copy()
    scene.bbox_max = t.bbox_max.copy()
    return scene


def renderer(cfg: dict, settings: dict, width: int, height: int, seed: int, device: str, flare: bool, **extra):
    """A ``Renderer`` with ``settings`` (and ``extra`` fields) and the configuration's masks and flare
    at ``width`` x ``height``; the render seed is ``seed`` (the flare's falloff key with it)."""
    from lens_flare_tpu_torch.lens.aperture import ApertureTexture
    from lens_flare_tpu_torch.renderer import Renderer

    kw = dict(settings)
    if flare and "flare" in cfg:
        f = cfg["flare"]
        kw.update(
            flare_intensity=f["flare_intensity"], flare_radius=f["flare_radius"], lens_model=f["lens_model"],
            aperture=ApertureTexture.from_array(mask(f["aperture_mask"])),
            ghost_aperture=ApertureTexture.from_array(mask(f["ghost_mask"])),
        )
    if "bokeh_mask" in cfg:
        kw["bokeh"] = ApertureTexture.from_array(mask(cfg["bokeh_mask"]))
    return Renderer(width=width, height=height, seed=seed, device=device, **kw, **extra)


def capture_s(r) -> float:
    """Seconds the renderer's captured programs (frames and ghost buffers) took to capture."""
    return float(r._programs.capture_s + r._flare_programs.capture_s)


def programs(r) -> int:
    """How many programs the renderer holds captured (frames and ghost buffers)."""
    return len(r._programs) + len(r._flare_programs)


def trace_roofline(r, terrain: Terrain, lanes: int, seed: int) -> dict | None:
    """The cell's trace kernels timed alone (CUDA events) on its camera, bounce and shadow
    wavefronts, each with its bound; ``share`` = sum of bounds / sum of times.  None where the
    scene takes no cluster-tree walk (kernel C's brute force, kernel G's binary BVH)."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.scene.camera import camera_params

    cs = r.bundle.cscene
    if cs is None or cs.brute:
        return None
    cam = camera_params(r.camera, torch.device(r.device))._asdict()
    coherent = ic.tree_closest_shade if cs.shade and not cs.stream else ic.tree_closest_hit
    closest = ic.tree_closest_shade if cs.shade else ic.tree_closest_hit
    waves = roofline.wavefronts(
        lambda *rays: coherent(cs, *rays), cam, lambda slot: cs.tri[slot, :9],
        r.width, r.height, lanes, terrain.light_position[1], seed,
    )
    rows, sum_ms, sum_bound = {}, 0.0, 0.0
    for name, fn, kind in (("camera", coherent, "closest"), ("bounce", closest, "closest"),
                           ("shadow", ic.tree_any_hit, "any")):
        rays = waves[name]
        ms = roofline.cuda_ms(lambda: fn(cs, *rays))
        b_ms, by = roofline.bound_ms(roofline.work(cs, kind, rays, fn(cs, *rays)))
        kernel = {ic.tree_closest_shade: "D", ic.tree_closest_hit: "A", ic.tree_any_hit: "B"}[fn]
        rows[name] = {"kernel": kernel, "ms": ms, "bound_ms": b_ms, "bound_by": by}
        sum_ms += ms
        sum_bound += b_ms
    return {"rows": rows, "share": sum_bound / sum_ms}
