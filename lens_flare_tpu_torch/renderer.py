"""Render controller: scene setup, tiled wavefront rendering, file output.

Counterpart of ``lens_flare_tpu/renderer.py``.  The film is traced as
``tile_pixels``-lane wavefronts in 32x32 pixel-block order (the reference's
tile size), every ray through the CUDA kernels of ``ops/intersect_cuda.py``
on a CUDA device (their plain PyTorch versions on the CPU).  Not ported yet
(ROADMAP Queue 1, item 6): COLLADA loading, the host-repacked adaptive
render, checkpoints, autofocus, env maps and multi-device rendering.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from lens_flare_tpu.accel.wide import build_wide_bvh
from lens_flare_tpu.scene.build import FlatScene

from . import _rng
from .integrator.lights import lights_to_device
from .integrator.path import RenderSettings, SceneBundle, make_settings, render_wavefront
from .integrator.shading import bsdf_to_device
from .lens.aperture import ApertureTexture
from .ops.intersect import scene_to_device
from .ops.intersect_cuda import CudaScene
from .scene.camera import Camera, camera_params
from .utils import image as img


@dataclass
class RenderStats:
    wall_time: float = 0.0
    bvh_build_time: float = 0.0
    total_rays: int = 0  # live wavefront lanes traced
    total_isects: int = 0  # primitive intersection tests, counted in the kernels
    total_zero_skipped: int = 0  # NEE lanes skipped as provably zero
    mrays_per_s: float = 0.0
    isects_per_ray: float = 0.0


def blocked_order(xs: np.ndarray, ys: np.ndarray, width: int, bs: int = 32) -> np.ndarray:
    """Permutation that orders pixels by 32x32 block, then row-major inside it."""
    return np.argsort(
        ((ys // bs) * ((width + bs - 1) // bs) + (xs // bs)) * bs * bs + (ys % bs) * bs + (xs % bs),
        kind="stable",
    )


@dataclass
class Renderer:
    """Offline renderer on one device (``"cuda"`` or ``"cpu"``)."""

    width: int = 800
    height: int = 600
    ns_aa: int = 1
    max_ray_depth: int = 1
    ns_area_light: int = 1
    samples_per_batch: int = 64
    max_tolerance: float = 0.05
    direct_hemisphere_sample: bool = False
    indirect: bool = True
    lens_radius: float = 0.0  # > 0 (thin lens) is not ported yet
    aperture_path: str | None = None
    ghost_aperture_path: str | None = None
    # in-memory aperture masks; each takes precedence over its path
    aperture: ApertureTexture | None = None
    ghost_aperture: ApertureTexture | None = None
    flare_intensity: float = 0.0
    flare_radius: float = 0.0
    tile_pixels: int = 1 << 16  # wavefront width per launch
    seed: int = 0
    device: str = "cuda"

    scene: FlatScene = None
    camera: Camera = None
    bundle: SceneBundle = None
    settings: RenderSettings = None
    stats: RenderStats = field(default_factory=RenderStats)

    def load_flat_scene(self, scene: FlatScene, camera: Camera | None = None) -> None:
        """Use an already-built FlatScene (procedural scenes, tests)."""
        self.scene = scene
        if camera is not None:
            self.camera = camera
        elif self.camera is None:
            self.camera = Camera()
            center = (scene.bbox_min + scene.bbox_max) / 2
            extent = np.linalg.norm(scene.bbox_max - scene.bbox_min)
            self.camera.place(center, math.pi / 3, math.pi / 4, extent, extent / 10, extent * 10)
            self.camera.screen_w, self.camera.screen_h = self.width, self.height
        self._build()

    def _build(self) -> None:
        if self.scene.num_spheres > 64:
            raise ValueError("the trace kernels test at most 64 spheres")
        # check the scene against the ported feature set before building
        self.update_settings()
        t0 = time.perf_counter()
        wb = build_wide_bvh(self.scene.tri_p)
        self.stats.bvh_build_time = time.perf_counter() - t0
        dev = torch.device(self.device)
        self.bundle = SceneBundle(
            scene=scene_to_device(self.scene, dev),
            bsdfs=bsdf_to_device(self.scene.bsdfs, dev),
            lights=lights_to_device(self.scene.lights, dev),
            cscene=CudaScene.from_wide_bvh(
                wb, self.scene.sph_center, self.scene.sph_radius, self.scene.num_triangles, dev
            ),
        )

    def update_settings(self) -> None:
        """Rebuild the RenderSettings from the current knobs (host only)."""
        self.settings = make_settings(
            self.scene.lights,
            bsdf_table=self.scene.bsdfs,
            ns_aa=self.ns_aa,
            max_ray_depth=self.max_ray_depth,
            ns_area_light=self.ns_area_light,
            samples_per_batch=self.samples_per_batch,
            max_tolerance=self.max_tolerance,
            direct_hemisphere_sample=self.direct_hemisphere_sample,
            indirect=self.indirect,
            use_thin_lens=self.lens_radius > 0,
        )

    def render(self, cell=None, progress: bool = True):
        """Render the film (or a subwindow ``cell=(x, y, dx, dy)``).

        Returns (hdr (H, W, 3) float32, sample_counts (H, W) int32), both
        tensors on the renderer's device.
        """
        if self.ns_aa > self.settings.samples_per_batch and self.max_tolerance > 0:
            raise NotImplementedError(
                "the host-repacked adaptive render is not ported yet (ROADMAP Queue 1, item 6)"
            )
        w, h = self.width, self.height
        x0, y0, dx, dy = (0, 0, w, h) if cell is None else cell
        dev = torch.device(self.device)
        cam = camera_params(self.camera, dev)
        key = _rng.prng_key(self.seed, device=dev)

        ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
        xs = xs.ravel()
        ys = ys.ravel()
        order = blocked_order(xs, ys, w)
        xs = torch.as_tensor(xs[order], device=dev)
        ys = torch.as_tensor(ys[order], device=dev)
        n_px = xs.shape[0]

        film = torch.zeros((h, w, 3), device=dev)
        counts = torch.zeros((h, w), dtype=torch.int32, device=dev)
        total = torch.zeros(3, dtype=torch.float64, device=dev)
        tile = self.tile_pixels
        n_tiles = -(-n_px // tile)
        t_start = time.perf_counter()
        for ti in range(n_tiles):
            px = xs[ti * tile : (ti + 1) * tile]
            py = ys[ti * tile : (ti + 1) * tile]
            m = px.shape[0]
            # pad to the common tile width; padded lanes are valid=False
            need = tile if n_tiles > 1 else m
            valid = torch.arange(need, device=dev) < m
            if need > m:
                px = torch.cat([px, px[-1:].expand(need - m)])
                py = torch.cat([py, py[-1:].expand(need - m)])
            rad, cnt, st = render_wavefront(
                self.bundle, self.settings, cam, px, py, w, h, key, valid
            )
            total += st
            film[py[:m], px[:m]] = rad[:m]
            counts[py[:m], px[:m]] = cnt[:m]
            if progress:
                print(f"\r[PathTracer] Rendering... {100 * (ti + 1) // n_tiles}%", end="", flush=True)
        total = total.cpu().numpy()  # waits for the device
        self.stats.wall_time = time.perf_counter() - t_start
        self.stats.total_rays = int(total[0])
        self.stats.total_isects = int(total[1])
        self.stats.total_zero_skipped = int(total[2])
        self.stats.mrays_per_s = self.stats.total_rays / max(self.stats.wall_time, 1e-9) / 1e6
        self.stats.isects_per_ray = self.stats.total_isects / max(self.stats.total_rays, 1)
        if progress:
            print(
                f"\n[PathTracer] Rendering complete: {self.stats.wall_time:.4f} sec\n"
                f"[PathTracer] Rays traced: {self.stats.total_rays} "
                f"({self.stats.mrays_per_s:.2f} Mrays/s)\n"
                f"[PathTracer] Intersection tests per ray: {self.stats.isects_per_ray:.2f}"
            )
        return film, counts

    def flare_pipeline(self):
        """The FlarePipeline for this frame, or None when no flare is configured."""
        if (
            self.aperture is None and self.aperture_path is None
            and self.ghost_aperture is None and self.ghost_aperture_path is None
        ):
            return None
        from .flare.pipeline import FlarePipeline

        return FlarePipeline.from_renderer(self)

    def composite_flare(self, hdr: torch.Tensor) -> torch.Tensor:
        """Add ghost buffer + starburst + falloff if a flare is configured."""
        pipeline = self.flare_pipeline()
        return hdr if pipeline is None else pipeline.composite(hdr)

    def render_to_file(self, filename, cell=None) -> torch.Tensor:
        hdr, counts = self.render(cell=cell)
        hdr = self.composite_flare(hdr)
        # film row 0 is the bottom of the view: flip on save
        img.save_hdr_png(filename, hdr.cpu().numpy(), flip_y=True)
        rate_path = Path(filename)
        rate_path = rate_path.with_name(rate_path.stem + "_rate.png")
        img.save_png(
            rate_path,
            img.sampling_rate_heatmap(counts.cpu().numpy(), max(self.ns_aa, 1))[::-1],
        )
        print(f"[PathTracer] saved to {filename}")
        return hdr
