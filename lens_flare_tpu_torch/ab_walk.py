"""A/B of the trace kernels A-F between two versions of ``ops/csrc/intersect.cu``, on the card.

    python -m lens_flare_tpu_torch.ab_walk --baseline DIR [--out PATH]

``DIR`` holds the other version's ``intersect.cu`` and the ``rng.cu`` and
``shade.cu`` built with it (for example the parent commit's, from ``git
show``; a version without one of those takes the checkout's).  Both are built with
``ops/_build.py``'s flags and loaded into one process; the wrappers launch
whichever is current, so every step sees the same Python, scenes and rays.
The steps alternate, baseline, checkout, checkout, baseline (``ORDER``), and
each measures:

- kernel rows at 65,536 lanes: random pixels of a 1920x1080 film
  (``bench_kernels.random_rays``) and the renderer's own wavefronts, the
  first 65,536 pixels in 32x32-block order (``bench_kernels.wavefronts``).
  A on camera rays at 524,288 and 131,072 triangles (PERF.md rows 2 and 1),
  on the blocked camera and bounce wavefronts at 524,288 (``terrain_1080p``'s
  closest hits), and on the single-level 128-triangle tree (chunk batch 2);
  C on that scene's random and blocked shadow rays (rows 4) and, with the
  closest-hit flag, its random camera rays (row 5);
  D on camera rays and the blocked camera and bounce wavefronts at 131,072;
  B on random and blocked shadow rays at 131,072 and 524,288.  At the
  kernel bench's shapes, the 262,144-lane wavefronts of the 512x512 film:
  A on the primary and bounce rays of the single-level 128-triangle tree,
  F on the bounce and shadow rays of 131,072 triangles at top_batch 2
  and 4, and E on the primary and bounce rays of both exact-fit trees
  (``bench_kernels.MXU_SCENES``, row 7), with A on the same trees and rays
  as its control.  Device ms:
  the CUDA-event mean of ``REPEATS`` calls after a warm-up
  (``bench_kernels.cuda_ms``); ``<row>_host``: the host's ms per call to
  enqueue them.  Every step's outputs must equal the first step's bit for
  bit.  Before the steps, each row's bound (``bench_kernels.bound``) from
  the first outputs, and each F row once per build under
  ``torch.profiler``: each kernel's device ms in one call (``F_passes``).
- ``terrain_1080p`` (``chip_smoke.py`` phase 3: render and flare composite),
  ``small_frame`` (phase 4: 320x240, 128 triangles, kernels A and C) and
  ``config2_frame`` (phase 5): one untraced frame after a warm-up
  (``frame_s``), then one frame under ``torch.profiler``: device ms and
  launches per kernel, A's, B's, C's and D's ms per frame, and the device's
  busy share (the union of its kernel and copy intervals over the traced
  frame's wall time); ``frame_profile`` also reports G's ms per frame.

It prints one JSON line per step and writes them all, with the card's
``nvidia-smi`` line, to ``--out`` (default ``_build/ab_walk.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import bench_kernels as bk
from .lens.aperture import ApertureTexture, polygon_mask
from .ops import _build
from .ops import intersect_cuda as ic
from .accel.wide import build_wide_bvh
from .renderer import Renderer
from .scene.procedural import make_terrain_scene

LANES = 1 << 16  # the main path's wavefront (Renderer.tile_pixels)
BENCH_LANES = 1 << 18  # the kernel bench's wavefront (E's and F's path)
REPEATS = 20
ORDER = "BCCB"  # B the baseline, C this checkout
DEFAULT_OUT = Path(__file__).resolve().parent / "_build" / "ab_walk.json"
# A's, D's, B's, C's and G's kernels as the profiler names them: the warp
# walk, and the names they had before it took them (A's one-thread-per-ray
# kernel, the one-flag template of B and D)
TRACE_NAMES = {
    "A": ("warp_walk_kernel<false, false", "tree_kernel("),
    "D": ("warp_walk_kernel<false, true", "warp_walk_kernel<false>"),
    "B": ("warp_walk_kernel<true, false", "warp_walk_kernel<true>"),
    "C": ("brute_kernel<",),
    "G": ("bvh_walk_kernel<",),
}
# the small frame (chip_smoke.py phase 4): 320x240 of the 128-triangle terrain
SMALL = dict(width=320, height=240, ns_aa=1, max_ray_depth=4, indirect=True, seed=0)


def config2_renderer(nq: int, device="cuda", **kw) -> tuple[Renderer, dict]:
    """BASELINE config 2 on terrain ``nq``: thin lens, octagon bokeh, adaptive; focused at the centre.

    Returns the renderer and its settings (``kw`` included), so that a
    second renderer can be built with the same ones.
    """
    scene = make_terrain_scene(nq)
    settings = dict(
        max_tolerance=0.05, max_ray_depth=4, ns_area_light=1, indirect=True, seed=0,
        lens_radius=0.01 * float(np.linalg.norm(scene.bbox_max - scene.bbox_min)),
        bokeh=ApertureTexture.from_array(polygon_mask(500, 8)), **kw,
    )
    r = Renderer(device=device, **settings)
    r.load_flat_scene(scene)
    focal = r.autofocus(r.width / 2, r.height / 2)
    assert 0 < focal < r.camera.f_clip, f"autofocus missed the scene: {focal}"
    return r, settings


def terrain_1080p(device="cuda", **kw):
    """The ``terrain_1080p`` frame: 524,288 triangles, 1920x1080, 1 spp, depth 4, NEE + RR, with the flare.

    ``kw``: more ``Renderer`` fields (``devices``).  Returns (renderer, flare
    pipeline, frame), where frame() renders and composites one frame ->
    (hdr, counts, flared).
    """
    r = Renderer(
        width=1920, height=1080, ns_aa=1, max_ray_depth=4, ns_area_light=1, indirect=True,
        seed=0, flare_intensity=1.5, flare_radius=30.0, device=device,
        aperture=ApertureTexture.from_array(polygon_mask(256, 5, rotation=0.3)),
        ghost_aperture=ApertureTexture.from_array(polygon_mask(64, 6)), **kw,
    )
    r.load_flat_scene(make_terrain_scene(512))
    pipeline = r.flare_pipeline()
    assert pipeline is not None, "the terrain's sun must project on screen"
    pipeline.starburst()  # aperture FFT cached outside the timed frame, as bench.py does

    def frame():
        hdr, counts = r.render(progress=False)
        return hdr, counts, pipeline.composite(hdr)

    return r, pipeline, frame


@dataclasses.dataclass
class Row:
    """One kernel call on fixed inputs: ``call(cs, rays)`` launches it."""

    label: str
    key: str  # the kernel, "A" to "F"
    any_hit: bool
    cs: ic.CudaScene
    rays: tuple
    call: object

    def run(self):
        return self.call(self.cs, self.rays)


def kernel_rows(device) -> list[Row]:
    """Every timed row, on fixed inputs."""
    def closest(cs, a):
        return ic.tree_closest_hit(cs, *a)

    def any_hit(cs, a):
        return ic.tree_any_hit(cs, *a)

    def shaded(cs, a):
        return ic.tree_closest_shade(cs, *a)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for nq in (8, 256, 512):
        r = Renderer(width=1920, height=1080, max_ray_depth=4, device=str(device))
        r.load_flat_scene(make_terrain_scene(nq))
        cs = r.bundle.cscene
        rnd = bk.random_rays(r, LANES, gen)
        camera, bounce, shadow = bk.wavefronts(r, LANES)
        rows.append(Row(f"A_t{nq}_camera_random", "A", False, cs, rnd["camera"], closest))
        if nq == 8:  # the single-level tree; its shadow rays take kernel C
            rows += [
                Row("C_t8_shadow_random", "C", True, cs, rnd["shadow"], lambda cs, a: ic.brute_hit(cs, *a)),
                Row("C_t8_shadow_blocked", "C", True, cs, shadow, lambda cs, a: ic.brute_hit(cs, *a)),
                Row("C_closest_t8_camera_random", "C", False, cs, rnd["camera"],
                    lambda cs, a: ic.brute_hit(cs, *a, any_hit=False)),
            ]
            continue
        rows += [Row(f"B_t{nq}_shadow_random", "B", True, cs, rnd["shadow"], any_hit),
                 Row(f"B_t{nq}_shadow_blocked", "B", True, cs, shadow, any_hit)]
        if cs.shade:
            rows += [Row("D_t256_camera_random", "D", False, cs, rnd["camera"], shaded),
                     Row("D_t256_camera_blocked", "D", False, cs, camera, shaded),
                     Row("D_t256_bounce_blocked", "D", False, cs, bounce, shaded)]
        else:
            rows += [Row(f"A_t{nq}_camera_blocked", "A", False, cs, camera, closest),
                     Row(f"A_t{nq}_bounce_blocked", "A", False, cs, bounce, closest)]
    # the kernel bench's shapes: A on terrain 8's single-level tree, F on
    # terrain 256, E and A on the exact-fit trees
    r = bk.build_renderer(8, device)
    primary, bounce, _ = bk.wavefronts(r, BENCH_LANES)
    for kind, rays in (("primary", primary), ("bounce", bounce)):
        rows.append(Row(f"A_t8_bench_{kind}", "A", False, r.bundle.cscene, rays, closest))
    r = bk.build_renderer(256, device)
    _, bounce, shadow = bk.wavefronts(r, BENCH_LANES)
    for tb in (2, 4):
        for kind, rays, hit_any in (("bounce", bounce, False), ("shadow", shadow, True)):
            rows.append(Row(f"F_t256_{kind}_tb{tb}", "F", hit_any, r.bundle.cscene, rays,
                            lambda cs, a, tb=tb, hit_any=hit_any: ic.tree_group(cs, *a, tb, any_hit=hit_any)))
    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    for nq, shape in bk.MXU_SCENES:
        scene = make_terrain_scene(nq)
        cs = ic.CudaScene.from_wide_bvh(build_wide_bvh(scene.tri_p, *shape), *none, scene.num_triangles, device,
                                        mxu=True)
        for kind, rays in bk.mxu_rays(scene, BENCH_LANES, device).items():
            rows += [Row(f"E_t{nq}_bench_{kind}", "E", False, cs, rays, lambda cs, a: ic.tree_closest_mxu(cs, *a)),
                     Row(f"A_t{nq}_mxu_tree_{kind}", "A", False, cs, rays, closest)]
    return rows


def call_profile(fn) -> dict:
    """Device ms of each kernel one warm call of fn() launches, by name (F's passes)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            kernel = re.search(r"(\w+(?:<[^()]*>)?)\(", e.name)  # "void ns::name<args>(float const*, ..."
            name = kernel.group(1) if kernel else e.name
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def frame_profile(frame) -> dict:
    """frame_s of an untraced frame(), then one traced frame's device time by kernel and busy share."""
    from torch.profiler import ProfilerActivity, profile

    frame()  # warm-up
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t0 = time.perf_counter()
    frame()
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ic.KERNELS.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        if not e.name.startswith(("Memcpy", "Memset")):
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += ms
            entry[1] += 1
    if not spans:
        raise RuntimeError("the profiler recorded no device events")
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo, hi = busy_us + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy_us += hi - lo
    out = {
        "frame_s": frame_s, "traced_s": traced_s, "launches": launches,
        "kernel_ms": sum(v[0] for v in by_name.values()), "kernel_launches": sum(v[1] for v in by_name.values()),
        "busy_share_traced": busy_us / 1e3 / (traced_s * 1e3),
    }
    for key, pats in TRACE_NAMES.items():
        hits = [v for name, v in by_name.items() if any(p in name for p in pats)]
        out[f"{key}_ms"] = sum(v[0] for v in hits)
        out[f"{key}_calls"] = sum(v[1] for v in hits)
    out["top_kernels"] = [[name[:120], ms, n] for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="directory holding the baseline intersect.cu")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B measures kernels on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas = {}
    libs = {}
    for tag, build in (("B", lambda: _build.build(Path(args.baseline))), ("C", _build.build)):
        _build.build_log = ""
        libs[tag] = _build.open_library(build())
        ptxas[tag] = _build.ptxas_report(_build.build_log)
    _build._lib = libs["C"]
    device = torch.device("cuda")
    rows = kernel_rows(device)
    bounds = {}
    for row in rows:
        if row.key != "F":  # F's bound needs the default walk's tests (chip_smoke.py phase 7)
            bounds[row.label] = bk.bound(row.cs, row.key, row.any_hit, row.rays, row.run())
    r2 = config2_renderer(256, width=1920, height=1080, ns_aa=16, samples_per_batch=4)[0]
    rs = Renderer(device="cuda", **SMALL)
    rs.load_flat_scene(make_terrain_scene(8))
    frames = {"terrain_1080p": terrain_1080p()[2], "small_frame": lambda: rs.render(progress=False),
              "config2_frame": lambda: r2.render(progress=False)}
    smi = bk.nvidia_smi()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas,
                      "bounds": bounds}), flush=True)
    # F's passes under the profiler, each build once, before any frame is
    # traced (short sessions after the frames' long ones came back empty)
    passes = {}
    for tag in "CB":
        _build._lib = libs[tag]
        passes[tag] = {row.label: call_profile(row.run) for row in rows if row.key == "F"}
    print(json.dumps({"F_passes": passes}), flush=True)
    first, steps = {}, []
    for tag in ORDER:
        _build._lib = libs[tag]
        step = {"step": tag}
        for row in rows:
            got = row.run()
            torch.cuda.synchronize()
            if row.label in first:
                assert all(torch.equal(x, y) for x, y in zip(got, first[row.label])), f"{tag}: {row.label} differs"
            else:
                first[row.label] = got
            step[row.label] = bk.cuda_ms(row.run, REPEATS)
            t0 = time.perf_counter()
            for _ in range(REPEATS):
                row.run()
            step[f"{row.label}_host"] = (time.perf_counter() - t0) * 1e3 / REPEATS
            torch.cuda.synchronize()
        for name, frame in frames.items():
            step[name] = frame_profile(frame)
        steps.append(step)
        print(json.dumps(step), flush=True)
    _build._lib = libs["C"]
    artifact = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas, "lanes": LANES,
                "bench_lanes": BENCH_LANES, "repeats": REPEATS, "bounds": bounds, "F_passes": passes,
                "steps": steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
