"""Render controller: scene setup, tiled wavefront rendering, file output.

Counterpart of ``lens_flare_tpu/renderer.py``.  The film is traced as
``tile_pixels``-lane wavefronts in 32x32 pixel-block order (the reference's
tile size), every ray through the CUDA kernels of ``ops/intersect_cuda.py``
on a CUDA device (their plain PyTorch versions on the CPU).  With
``ns_aa > samples_per_batch`` the render is adaptive: converged pixels leave
the wavefront between stages and the active set is repacked.  Not ported
yet (ROADMAP Queue 1, item 6): COLLADA loading, checkpoints, env maps and
multi-device rendering.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import _rng
from .accel.wide import build_wide_bvh
from .integrator.lights import lights_to_device
from .integrator.path import (
    BokehMask,
    RenderSettings,
    SceneBundle,
    make_settings,
    render_batch,
    render_wavefront,
    trace_closest,
)
from .integrator.shading import bsdf_to_device
from .lens.aperture import ApertureTexture
from .ops.intersect import scene_to_device, shade_rows
from .ops.intersect_cuda import CudaScene
from .scene.build import FlatScene
from .scene.camera import Camera, camera_params, generate_rays
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
    active_per_stage: list = field(default_factory=list)  # adaptive: pixels left after each stage


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
    lens_radius: float = 0.0  # > 0: thin-lens camera
    focal_distance: float = 0.0
    aperture_path: str | None = None
    ghost_aperture_path: str | None = None
    bokeh_path: str | None = None  # aperture-shaped depth of field (config 2)
    # in-memory aperture masks; each takes precedence over its path
    aperture: ApertureTexture | None = None
    ghost_aperture: ApertureTexture | None = None
    bokeh: ApertureTexture | None = None
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
        self.camera.lens_radius = self.lens_radius
        self.camera.focal_distance = self.focal_distance
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
        bokeh = None
        if self.lens_radius > 0 and (self.bokeh is not None or self.bokeh_path):
            tex = self.bokeh if self.bokeh is not None else ApertureTexture.load(self.bokeh_path)
            bokeh = BokehMask.from_texture(tex.values, dev)
        self.bundle = SceneBundle(
            scene=scene_to_device(self.scene, dev),
            bsdfs=bsdf_to_device(self.scene.bsdfs, dev),
            lights=lights_to_device(self.scene.lights, dev),
            cscene=CudaScene.from_wide_bvh(
                wb, self.scene.sph_center, self.scene.sph_radius, self.scene.num_triangles, dev,
                shade_rows=shade_rows(self.scene) if self.scene.num_triangles else None,
            ),
            bokeh=bokeh,
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

        film = torch.zeros((h, w, 3), device=dev)
        counts = torch.zeros((h, w), dtype=torch.int32, device=dev)
        t_start = time.perf_counter()
        if self.ns_aa > self.settings.samples_per_batch and self.max_tolerance > 0:
            rad, cnt, total = self._adaptive_render(cam, key, xs, ys, progress)
            film[ys, xs] = rad
            counts[ys, xs] = cnt
        else:
            total = self._tiled_render(cam, key, xs, ys, film, counts, progress)
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

    def _tiled_render(self, cam, key, xs, ys, film, counts, progress):
        """Every pixel's ns_aa samples, one ``tile_pixels``-lane wavefront at a time.

        Writes film and counts in place; returns the stats, on the device.
        """
        dev = xs.device
        w, h = self.width, self.height
        n_px = xs.shape[0]
        total = torch.zeros(3, dtype=torch.float64, device=dev)
        tile = self.tile_pixels
        n_tiles = -(-n_px // tile)
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
        return total

    def _adaptive_render(self, cam, key, xs, ys, progress):
        """Adaptive sampling with host repacking (``renderer.py:470-610``, no checkpoints).

        Stages follow the geometric schedule (spb, spb, 2spb, 4spb, ...).  A
        stage dispatches every tile of the active set before anything is
        read back; the 95% CI test then runs over the whole active set on the
        device, and selecting the survivors is the stage's one sync.  Film
        sums are float32, s1 and s2 float64, as in the reference.
        Returns (radiance (P, 3), counts (P,), stats) in the order of xs, ys.
        """
        spb = min(self.samples_per_batch, self.ns_aa)
        schedule = []
        done, step = 0, spb
        while done < self.ns_aa:
            schedule.append(min(step, self.ns_aa - done))
            done += schedule[-1]
            if len(schedule) >= 2:
                step *= 2

        dev = xs.device
        n = xs.shape[0]
        film = torch.zeros((n, 3), device=dev)
        s1 = torch.zeros(n, dtype=torch.float64, device=dev)
        s2 = torch.zeros(n, dtype=torch.float64, device=dev)
        count = torch.zeros(n, dtype=torch.int32, device=dev)
        stats = torch.zeros(3, dtype=torch.float64, device=dev)
        active = torch.arange(n, device=dev)
        n_active = n
        s_done = 0
        tile = self.tile_pixels
        self.stats.active_per_stage = []
        for ns in schedule:
            if n_active == 0:
                break
            for i in range(0, n_active, tile):
                idx = active[i : i + tile]
                f, a1, a2, st = render_batch(
                    self.bundle, self.settings, cam, xs[idx], ys[idx],
                    self.width, self.height, key, s_done, ns,
                )
                film.index_add_(0, idx, f)
                s1.index_add_(0, idx, a1.double())
                s2.index_add_(0, idx, a2.double())
                count[idx] += ns
                stats += st
            s_done += ns
            # 95% CI early stop over the whole active set, then repack
            nc = torch.clamp_min(count[active], 2).double()
            a1, a2 = s1[active], s2[active]
            var = torch.clamp_min(a2 - a1 * a1 / nc, 0.0) / (nc - 1.0)
            ci = 1.96 * torch.sqrt(var / nc)
            active = active[ci > self.max_tolerance * a1 / nc]  # the stage's sync
            n_active = active.shape[0]
            self.stats.active_per_stage.append(n_active)
            if progress:
                print(
                    f"\r[PathTracer] Rendering... {100 * s_done // self.ns_aa}% ({n_active} px active)",
                    end="", flush=True,
                )
        rad = film / torch.clamp_min(count, 1)[:, None]
        return rad, count, stats

    def autofocus(self, x: float, y: float) -> float:
        """Set the focal distance to the hit depth under pixel (x, y) (``renderer.py:627``)."""
        dev = torch.device(self.device)
        cam = camera_params(self.camera, dev)
        o, d = generate_rays(
            cam,
            torch.tensor([x / self.width], dtype=torch.float32, device=dev),
            torch.tensor([y / self.height], dtype=torch.float32, device=dev),
        )
        hit, _ = trace_closest(
            self.bundle, o.contiguous(), d,
            torch.tensor([self.camera.n_clip], dtype=torch.float32, device=dev),
            torch.tensor([self.camera.f_clip], dtype=torch.float32, device=dev),
        )
        self.focal_distance = float(hit.t[0])
        self.camera.focal_distance = self.focal_distance
        return self.focal_distance

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
