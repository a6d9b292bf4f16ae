"""Render controller: scene setup, tiled wavefront rendering, file output.

Counterpart of ``lens_flare_tpu/renderer.py``.  A scene comes from a
COLLADA file (:meth:`Renderer.load`) or is handed over built
(:meth:`Renderer.load_flat_scene`).  The film is traced as
``tile_pixels``-lane wavefronts in 32x32 pixel-block order (the reference's
tile size), every ray through the CUDA kernels of ``ops/intersect_cuda.py``
on a CUDA device (their plain PyTorch versions on the CPU): the cluster
tree's kernels A-D, or kernel G's binary-BVH walk past the tree's capacity
or when ``use_wide_tree`` is False.  With ``ns_aa > samples_per_batch`` the
render is adaptive: converged pixels leave the wavefront between stages and
the active set is repacked.  ``envmap`` (an (H, W, 3) radiance array, e.g.
from ``utils/exr.read``) lights the scene from an equirect environment
map: NEE samples it as one more light and camera rays that miss see it.
``render(checkpoint_path=)`` persists the film after each tile (the
adaptive render: its accumulators and active set after each stage) with a
fingerprint of the render, and an interrupted render resumes from it.
``composite_flare`` adds the flare: ghosts from the paraxial model or,
with ``lens_model="realistic"``, from the Snell + Fresnel lens stack.
``devices`` shards every wavefront over several devices (``parallel/``),
each shard on its device's replica of the scene, bit-equal to one device.

On a CUDA device the samples of a tile's ``render_wavefront`` and of a
chunk's ``render_batch`` run as captured CUDA graphs (``compiled.py``,
the counterparts of the JAX package's ``_render_jit`` and ``_batch_jit``):
per (settings, width, height, lanes), one program makes the pixel keys
and one traces a sample, replayed once per sample index.  Pixel indices,
``valid``, the keys, the sample index and the camera are copied into the
programs' static inputs; the sums over samples, the CI tests, the film
scatter, the stats sum and checkpoints run eagerly between replays, in
the order of an eager render.  ``compiled.disabled()`` runs a render
eagerly, as the CPU always does.
"""

from __future__ import annotations

import copy
import hashlib
import math
import os
import time
import zipfile
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import _rng
from .accel.bvh import build_bvh
from .accel.wide import build_wide_bvh, takes_wide_tree
from .integrator.envlight import build_env
from .integrator.lights import LT_ENV, lights_to_device
from .integrator.path import (
    BokehMask,
    RenderSettings,
    SceneBundle,
    make_settings,
    pixel_keys,
    radiance_sample,
    render_batch,
    render_wavefront,
    trace_closest,
)
from .compiled import Programs
from .integrator.shading import bsdf_to_device
from .lens.aperture import ApertureTexture
from .ops.intersect import bvh_to_device, scene_to_device, shade_rows
from .ops.intersect_cuda import CudaScene
from .parallel import mesh as parallel_mesh
from .parallel.mesh import group, make_mesh, replicate
from .parallel.render import shard_call
from .scene.build import FlatScene, load_scene
from .scene.camera import Camera, CameraParams, camera_params, generate_rays, place_from_scene_info
from .utils import image as img
from .utils.profiling import span


@dataclass
class RenderStats:
    wall_time: float = 0.0
    bvh_build_time: float = 0.0
    bvh_pack_time: float = 0.0  # bvh_to_device: kernel G's records and rows, packed and uploaded
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


def pad_lanes(px: torch.Tensor, py: torch.Tensor, tile: int, grain: int, multiple: int = 1):
    """Pad a ragged chunk of ``m`` pixels to a bucket of ``grain`` lanes, at most ``tile``.

    The padded lanes repeat the last pixel and are ``valid=False``: they
    trace nothing.  Each bucket width is one pair of captured programs, as
    each is one compile in the JAX package (``renderer.py:548-564``,
    ``app.py:627-638``).  On a mesh of ``multiple`` shards the grain and
    the bucket are multiples of it (``tile`` already is).  Returns (px, py,
    valid, m).
    """
    m = px.shape[0]
    grain = -(-grain // multiple) * multiple
    bucket = max(min(-(-m // grain) * grain, tile), -(-m // multiple) * multiple)
    if bucket > m:
        px = torch.cat([px, px[-1:].expand(bucket - m)])
        py = torch.cat([py, py[-1:].expand(bucket - m)])
    return px, py, torch.arange(bucket, device=px.device) < m, m


@dataclass
class Renderer:
    """Offline renderer on one device (``"cuda"`` or ``"cpu"``).

    ``use_wide_tree`` is the counterpart of the JAX ``Renderer``'s
    ``use_pallas`` (``renderer.py:83``): None traces on the cluster tree
    (kernels A-D) up to its capacity and walks the binary BVH (kernel G, the
    JAX package's XLA walk) past it; False always walks the binary BVH; True
    always takes the cluster tree, and raises past its capacity.

    ``devices`` (``renderer.py:84-90``): 1 renders on ``device``; 0 on
    every device that ``parallel.mesh.available_devices`` finds (every CUDA
    device, or the one CPU), N on the first N of them.  Above one device
    each wavefront (a tile, or an adaptive chunk padded to a multiple of the
    mesh) is split into one contiguous shard per device, traced there
    against that device's replica of the scene through that device's
    captured programs, and gathered in order (``parallel.render.shard_call``);
    ``tile_pixels`` is rounded up to a multiple of the shard count.  Under a
    ``torch.distributed`` group, as the JAX mesh spans every host's
    devices, a ``devices`` other than 1 shards over every rank: each rank
    takes its block of each wavefront over its own devices (``devices``
    counts per process), and every rank gets the whole film.  The film,
    counts and stats equal one device's bit for bit, so a checkpoint
    resumes on any device count.
    """

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
    envmap: np.ndarray | None = None  # (H, W, 3) equirect radiance
    aperture_path: str | None = None
    ghost_aperture_path: str | None = None
    bokeh_path: str | None = None  # aperture-shaped depth of field (config 2)
    # in-memory aperture masks; each takes precedence over its path
    aperture: ApertureTexture | None = None
    ghost_aperture: ApertureTexture | None = None
    bokeh: ApertureTexture | None = None
    flare_intensity: float = 0.0
    flare_radius: float = 0.0
    lens_model: str = "paraxial"  # "realistic": the sequential Snell + Fresnel stack (config 3)
    camera_settings: str | None = None  # a Camera.dump_settings file applied by load()
    tile_pixels: int = 1 << 16  # wavefront width per launch
    seed: int = 0
    device: str = "cuda"
    use_wide_tree: bool | None = None  # None: by scene size (accel/wide.py:takes_wide_tree)
    devices: int = 1  # 1: one device; 0: all available; N: the first N

    scene: FlatScene = None
    camera: Camera = None
    bundle: SceneBundle = None
    settings: RenderSettings = None
    stats: RenderStats = field(default_factory=RenderStats)
    # captured programs on a CUDA device: the frames' samples and the flare's ghost buffers
    _programs: Programs = field(default_factory=Programs, init=False, repr=False, compare=False)
    _flare_programs: Programs = field(default_factory=Programs, init=False, repr=False, compare=False)
    # the mesh the wavefronts are sharded over (None: one device) and the scene on each of its devices
    _mesh: tuple | None = field(default=None, init=False, repr=False, compare=False)
    _replicas: dict | None = field(default=None, init=False, repr=False, compare=False)

    def _drop_programs(self) -> None:
        self._programs.clear()
        self._flare_programs.clear()

    def load(self, dae_path, build: bool = True) -> None:
        """Load a COLLADA scene and place the camera as the reference does (``renderer.py:99-115``).

        With ``camera_settings`` the file's intrinsics and pose are restored,
        but the frame stays ``width`` x ``height`` (main.cpp:187-194).
        ``build=False`` leaves the trees and the device bundle unbuilt, for a
        caller that edits the scene and hands it to :meth:`load_flat_scene`.
        """
        self._drop_programs()
        scene, info = load_scene(dae_path)
        self.scene = scene
        self.camera = Camera()
        self.camera.configure(info.camera, self.width, self.height)
        place_from_scene_info(self.camera, info, scene.bbox_min, scene.bbox_max)
        if self.camera_settings:
            self.camera.load_settings(self.camera_settings)
            self.camera.screen_w, self.camera.screen_h = self.width, self.height
        self.camera.lens_radius = self.lens_radius
        self.camera.focal_distance = self.focal_distance
        if build:
            self._build()
        else:
            self.bundle = self._replicas = None  # not the last scene's

    def set_frame_size(self, width: int, height: int) -> None:
        self._drop_programs()
        self.width, self.height = width, height
        if self.camera is not None:
            self.camera.set_screen_size(width, height)

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
        self._drop_programs()
        # any number of spheres; the route is decided before any build
        wide = takes_wide_tree(self.scene.num_triangles, self.use_wide_tree)
        # check the scene against the ported feature set before building
        self.update_settings()
        dev = torch.device(self.device)
        t0 = time.perf_counter()
        cscene = bvh = None
        with span("scene.build"):
            if wide:
                wb = build_wide_bvh(self.scene.tri_p)
            else:
                flat_bvh = build_bvh(*self.scene.primitive_bboxes())  # SAH, as the JAX Renderer's default
        self.stats.bvh_build_time = time.perf_counter() - t0
        with span("scene.upload"):
            if wide:
                cscene = CudaScene.from_wide_bvh(
                    wb, self.scene.sph_center, self.scene.sph_radius, self.scene.num_triangles, dev,
                    shade_rows=shade_rows(self.scene) if self.scene.num_triangles else None,
                )
            else:
                t0 = time.perf_counter()
                bvh = bvh_to_device(self.scene, flat_bvh, dev)
                self.stats.bvh_pack_time = time.perf_counter() - t0
            bokeh = None
            if self.lens_radius > 0 and (self.bokeh is not None or self.bokeh_path):
                tex = self.bokeh if self.bokeh is not None else ApertureTexture.load(self.bokeh_path)
                bokeh = BokehMask.from_texture(tex.values, dev)
            self.bundle = SceneBundle(
                scene=scene_to_device(self.scene, dev),
                bsdfs=bsdf_to_device(self.scene.bsdfs, dev),
                lights=lights_to_device(self.light_table(), dev),
                cscene=cscene,
                bokeh=bokeh,
                bvh=bvh,
                env=None if self.envmap is None else build_env(self.envmap, dev),
            )
            avail = parallel_mesh.available_devices(self.device)  # looked up here: a stand-in may replace it
            n_dev = len(avail) if self.devices == 0 else min(self.devices, len(avail))
            ranks = 1 if self.devices == 1 else group()[1]
            self._mesh = make_mesh(devices=avail[:n_dev]) if n_dev * ranks > 1 else None
            self._replicas = None
            if self._mesh is not None:
                self._replicas = replicate(self.bundle, self._mesh)  # once per build, not per tile
                # every wavefront divides over the shards of every rank
                self.tile_pixels = -(-self.tile_pixels // self.n_shards) * self.n_shards

    def light_table(self):
        """The scene's light table, with an LT_ENV row appended when there is an ``envmap``.

        The row goes on a copy (``renderer.py:145-160``): the scene's own
        table is left as it is, so a second ``_build`` adds no second row.
        """
        lt = self.scene.lights
        if self.envmap is None:
            return lt
        lt = copy.deepcopy(lt)
        zero = np.zeros(3, np.float32)
        lt.light_type = np.append(lt.light_type, LT_ENV).astype(np.int32)
        for name in ("radiance", "position", "direction", "dim_x", "dim_y"):
            setattr(lt, name, np.vstack([getattr(lt, name), zero]))
        lt.area = np.append(lt.area, 0.0).astype(np.float32)
        lt.is_delta = np.append(lt.is_delta, False)
        return lt

    def update_settings(self) -> None:
        """Rebuild the RenderSettings from the current knobs (host only).

        The programs are dropped when the settings change: the viewer calls
        this on every restart of its progressive render, and a restart with
        the same knobs (after an orbit, say) replays what it captured.
        """
        settings = make_settings(
            self.light_table(),
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
        if settings != self.settings:
            self._drop_programs()
        self.settings = settings

    def _checkpoint_fingerprint(self, cell) -> str:
        """Identity of a render for resuming (``renderer.py:257-291``).

        A checkpoint resumes only into a render of the same scene, camera,
        film, cell, seed and sampling plan: the hash covers everything that
        changes a pixel's estimate, the light and BSDF tables and the
        environment map included.
        """
        parts = [
            self.seed, self.width, self.height, cell, self.ns_aa,
            self.samples_per_batch, self.max_tolerance, self.max_ray_depth,
            self.ns_area_light, self.direct_hemisphere_sample, self.indirect,
            self.lens_radius, self.focal_distance,
            self.scene.num_triangles, self.scene.num_spheres,
        ]
        h = hashlib.sha256(repr(parts).encode())
        if self.camera is not None:
            for leaf in self.camera.params():
                h.update(np.asarray(leaf).tobytes())
        h.update(np.asarray(self.scene.bbox_min).tobytes())
        h.update(np.asarray(self.scene.bbox_max).tobytes())
        if self.bundle is not None:
            for group in (self.bundle.lights, self.bundle.bsdfs):
                for leaf in group:
                    h.update(leaf.detach().cpu().numpy().tobytes())
            if self.bundle.env is not None:
                h.update(self.bundle.env.data.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    @staticmethod
    def _atomic_savez(path, **arrays) -> None:
        """Write a checkpoint to a temporary file, then ``os.replace`` it over ``path``.

        A process that dies mid-write leaves the previous checkpoint whole.
        """
        tmp = str(path) + ".tmp.npz"  # np.savez appends .npz to a name without it
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    @staticmethod
    def _load_checkpoint(path):
        """Every array of the checkpoint at ``path``, or None when it is absent or unreadable."""
        if path is None or not Path(path).exists():
            return None
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile, zlib.error) as e:  # truncated zip, bad magic, ...
            print(f"[PathTracer] ignoring unreadable checkpoint {path}: {e}")
            return None

    def render(self, cell=None, progress: bool = True, checkpoint_path=None):
        """Render the film (or a subwindow ``cell=(x, y, dx, dy)``).

        Returns (hdr (H, W, 3) float32, sample_counts (H, W) int32), both
        tensors on the renderer's device.  ``checkpoint_path``: progress is
        saved there after each tile (adaptive: each stage), and a render
        interrupted before its end resumes from the file, unless the file
        belongs to another render (its fingerprint differs) or is unreadable.
        """
        with span("renderer.render"):
            w, h = self.width, self.height
            x0, y0, dx, dy = (0, 0, w, h) if cell is None else cell
            dev = torch.device(self.device)
            with span("renderer.prepare"):
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
                total = torch.zeros(3, dtype=torch.float64, device=dev)
            t_start = time.perf_counter()
            n_tiles = -(-xs.shape[0] // self.tile_pixels)
            ckpt = None
            start_tile = 0
            if checkpoint_path is not None:
                ckpt = (checkpoint_path, self._checkpoint_fingerprint(cell))
                ck = self._load_checkpoint(checkpoint_path)
                # "next_tile" marks the tiled (or completed) format; an adaptive
                # render's per-stage state is resumed in _adaptive_render
                if (
                    ck is not None and "next_tile" in ck and int(ck["n_tiles"]) == n_tiles
                    and ck["film"].shape == tuple(film.shape) and str(ck.get("fp")) == ckpt[1]
                ):
                    film = torch.as_tensor(ck["film"], device=dev)
                    counts = torch.as_tensor(ck["counts"], device=dev)
                    total = torch.as_tensor(ck["stats"], device=dev)
                    start_tile = int(ck["next_tile"])
                    if progress:
                        print(f"[PathTracer] resuming at tile {start_tile}/{n_tiles}")
            if self.ns_aa > self.settings.samples_per_batch and self.max_tolerance > 0:
                if start_tile < n_tiles:  # not already complete from a checkpoint
                    rad, cnt, total = self._adaptive_render(cam, key, xs, ys, progress, ckpt)
                    film[ys, xs] = rad
                    counts[ys, xs] = cnt
                    if ckpt is not None:
                        self._save_tiles(ckpt, film, counts, total, n_tiles, n_tiles)
            else:
                total = self._tiled_render(cam, key, xs, ys, film, counts, progress, total, start_tile, ckpt)
            with span("renderer.stats"):
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

    def _save_tiles(self, ckpt, film, counts, total, next_tile, n_tiles) -> None:
        path, fp = ckpt
        self._atomic_savez(
            path, film=film.cpu().numpy(), counts=counts.cpu().numpy(), stats=total.cpu().numpy(),
            next_tile=next_tile, n_tiles=n_tiles, fp=fp,
        )

    @property
    def n_shards(self) -> int:
        """The shards a wavefront is split into: the mesh's, over every rank of a process group."""
        return 1 if self._mesh is None else len(self._mesh) * group()[1]

    def _sampler(self, cam, key, px, py, valid, bundle=None):
        """``path.sampler`` through this renderer's programs: on a CUDA device the pixel keys come
        from one replay and each sample from another, both captured per (settings, width, height,
        lanes, device); elsewhere, or under ``compiled.disabled()``, the same functions run eagerly.
        ``bundle``: the scene on the lanes' device (a shard's replica), the renderer's by default."""
        # the programs' closures hold the bundle and settings, not the renderer: a renderer that
        # holds its programs and is held by them would be freed only by the cyclic collector
        bundle = self.bundle if bundle is None else bundle
        settings, w, h = self.settings, self.width, self.height

        def trace(base_keys, s_idx, px, py, valid, *cam):
            keys = _rng.fold_in(base_keys, s_idx)
            return radiance_sample(bundle, settings, CameraParams(*cam), keys, px, py, w, h, valid=valid)

        base_keys = self._programs.run(("keys", w), lambda px, py, key: pixel_keys(key, px, py, w), px, py, key)
        return lambda s_idx: self._programs.run(
            ("sample", settings, w, h), trace, base_keys, s_idx, px, py, valid, *cam
        )

    def _sharded(self, cam, key, px, py, valid, call):
        """``call(bundle, cam, key, px, py, valid)`` on the wavefront, or through
        ``parallel.render.shard_call`` over the mesh: per-lane outputs, then the stats."""
        if self._mesh is None:
            return call(self.bundle, cam, key, px, py, valid)
        return shard_call(self._mesh, self._replicas, call, cam, key, px, py, valid)

    def render_chunk(self, cam, key, px, py, valid, s_offset, n_samples: int):
        """``render_batch`` of samples ``s_offset ..`` on a padded chunk, through the programs and the
        mesh: the adaptive render's and the progressive viewer's unit."""
        w, h = self.width, self.height
        return self._sharded(cam, key, px, py, valid, lambda b, c, k, x, y, v: render_batch(
            b, self.settings, c, x, y, w, h, k, s_offset, n_samples, valid=v,
            sample=self._sampler(c, k, x, y, v, bundle=b),
        ))

    def _tiled_render(self, cam, key, xs, ys, film, counts, progress, total, start_tile=0, ckpt=None):
        """Every pixel's ns_aa samples, one ``tile_pixels``-lane wavefront at a time.

        Starts at tile ``start_tile`` with the stats ``total``; writes film
        and counts in place, and with ``ckpt`` (path, fingerprint) saves
        them after each tile.  Returns the stats, on the device.
        """
        dev = xs.device
        w, h = self.width, self.height
        n_px = xs.shape[0]
        tile = self.tile_pixels
        n_tiles = -(-n_px // tile)
        for ti in range(start_tile, n_tiles):
            with span("renderer.tile"):
                px = xs[ti * tile : (ti + 1) * tile]
                py = ys[ti * tile : (ti + 1) * tile]
                m = px.shape[0]
                # pad to the common tile width (a lone tile: to a multiple of the mesh); padded lanes are valid=False
                need = tile if n_tiles > 1 else -(-m // self.n_shards) * self.n_shards
                valid = torch.arange(need, device=dev) < m
                if need > m:
                    px = torch.cat([px, px[-1:].expand(need - m)])
                    py = torch.cat([py, py[-1:].expand(need - m)])
                rad, cnt, st = self._sharded(cam, key, px, py, valid, lambda b, c, k, x, y, v: render_wavefront(
                    b, self.settings, c, x, y, w, h, k, v, sample=self._sampler(c, k, x, y, v, bundle=b),
                ))
                total += st
                film[py[:m], px[:m]] = rad[:m]
                counts[py[:m], px[:m]] = cnt[:m]
            if ckpt is not None:
                self._save_tiles(ckpt, film, counts, total, ti + 1, n_tiles)
            if progress:
                print(f"\r[PathTracer] Rendering... {100 * (ti + 1) // n_tiles}%", end="", flush=True)
        return total

    def _adaptive_render(self, cam, key, xs, ys, progress, ckpt=None):
        """Adaptive sampling with host repacking (``renderer.py:470-610``).

        Stages follow the geometric schedule (spb, spb, 2spb, 4spb, ...).  A
        stage dispatches every tile of the active set before anything is
        read back; the 95% CI test then runs over the whole active set on the
        device, and selecting the survivors is the stage's one sync.  Film
        sums are float32, s1 and s2 float64, as in the reference.  With
        ``ckpt`` (path, fingerprint) the accumulators and the active set are
        saved after each stage, and a matching checkpoint resumes at its
        stage.  Returns (radiance (P, 3), counts (P,), stats) in the order
        of xs, ys.
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
        start_stage = s_done = 0
        ck = None if ckpt is None else self._load_checkpoint(ckpt[0])
        # spb sets the schedule and the samples' RNG offsets: a checkpoint of
        # another batch size would misalign both
        if (
            ck is not None and "stage" in ck and int(ck["n"]) == n and int(ck["ns_aa"]) == self.ns_aa
            and int(ck.get("spb", -1)) == spb and str(ck.get("fp")) == ckpt[1]
        ):
            film, s1, s2, count, active, stats = (
                torch.as_tensor(ck[k], device=dev) for k in ("film", "s1", "s2", "count", "active", "stats")
            )
            start_stage, s_done = int(ck["stage"]), int(ck["s_done"])
            if progress:
                print(
                    f"[PathTracer] resuming adaptive render at stage {start_stage}/{len(schedule)}"
                    f" ({active.shape[0]} px active)"
                )
        n_active = active.shape[0]
        tile = self.tile_pixels
        grain = 8192 if tile > 16384 else 256  # the JAX package's buckets (renderer.py:548-564)
        self.stats.active_per_stage = []
        for si, ns in enumerate(schedule[start_stage:], start_stage):
            if n_active == 0:
                break
            for i in range(0, n_active, tile):
                with span("renderer.tile"):
                    idx = active[i : i + tile]
                    px, py, valid, m = pad_lanes(xs[idx], ys[idx], tile, grain, self.n_shards)
                    f, a1, a2, st = self.render_chunk(cam, key, px, py, valid, s_done, ns)
                    film.index_add_(0, idx, f[:m])
                    s1.index_add_(0, idx, a1[:m].double())
                    s2.index_add_(0, idx, a2[:m].double())
                    count[idx] += ns
                    stats += st
            s_done += ns
            # 95% CI early stop over the whole active set, then repack
            with span("renderer.select"):
                nc = torch.clamp_min(count[active], 2).double()
                a1, a2 = s1[active], s2[active]
                var = torch.clamp_min(a2 - a1 * a1 / nc, 0.0) / (nc - 1.0)
                ci = 1.96 * torch.sqrt(var / nc)
                active = active[ci > self.max_tolerance * a1 / nc]  # the stage's sync
                n_active = active.shape[0]
            self.stats.active_per_stage.append(n_active)
            if ckpt is not None:
                self._atomic_savez(
                    ckpt[0], stage=si + 1, s_done=s_done, n=n, ns_aa=self.ns_aa, spb=spb, fp=ckpt[1],
                    **{k: v.cpu().numpy() for k, v in
                       dict(film=film, s1=s1, s2=s2, count=count, active=active, stats=stats).items()},
                )
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
        """The FlarePipeline for this frame, or None when no flare is configured.

        The realistic lens model needs no aperture: its ghosts alone are a
        flare (``renderer.py:651-662``).
        """
        if (
            self.aperture is None and self.aperture_path is None
            and self.ghost_aperture is None and self.ghost_aperture_path is None
            and self.lens_model != "realistic"
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
