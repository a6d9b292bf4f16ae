"""A/B of kernels B and D between two versions of ``ops/csrc/intersect.cu``, on the card.

    python -m lens_flare_tpu_torch.ab_walk --baseline DIR [--out PATH]

``DIR`` holds the other version's ``intersect.cu`` (for example the parent
commit's, from ``git show``).  Both are built with ``ops/_build.py``'s flags
and loaded into one process; the wrappers launch whichever is current, so
every step sees the same Python, scenes and rays.  The steps alternate,
baseline, checkout, checkout, baseline (``ORDER``), and each measures:

- kernel rows: D and B at PERF.md's table shapes (65,536 random pixels of a
  1920x1080 film, ``bench_kernels.random_rays``: D on camera rays at 131,072
  triangles, B on shadow rays at 524,288 and 131,072), and on the
  renderer's own wavefronts (the first 65,536 pixels in 32x32-block order,
  ``bench_kernels.wavefronts``: D camera and bounce at 131,072, B shadow at
  131,072 and 524,288); kernel A on camera rays at 524,288 as a control that
  neither version changes.  Device ms: the CUDA-event mean of ``REPEATS``
  calls after a warm-up (``bench_kernels.cuda_ms``); ``<row>_host``: the
  host's ms per call to enqueue them.  Every step's outputs must equal the
  first step's bit for bit.
- ``config2_frame`` (``chip_smoke.py`` phase 5): one untraced frame after a
  warm-up (``frame_s``), then one frame under ``torch.profiler``: device ms
  and launches per kernel, D's and B's ms per frame, and the device's busy
  share (the union of its kernel and copy intervals over the traced frame's
  wall time).

It prints one JSON line per step and writes them all, with the card's
``nvidia-smi`` line, to ``--out`` (default ``_build/ab_walk.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import bench_kernels as bk
from .lens.aperture import ApertureTexture, polygon_mask
from .ops import _build
from .ops import intersect_cuda as ic
from .renderer import Renderer
from .scene.procedural import make_terrain_scene

LANES = 1 << 16  # the main path's wavefront (Renderer.tile_pixels)
REPEATS = 20
ORDER = "BCCB"  # B the baseline, C this checkout
DEFAULT_OUT = Path(__file__).resolve().parent / "_build" / "ab_walk.json"
# D's and B's kernels as the profiler names them: the warp walk, and the
# one-thread-per-ray template they had before it
TRACE_NAMES = {
    "D": ("warp_walk_kernel<false>", "tree_kernel<false, true>"),
    "B": ("warp_walk_kernel<true>", "tree_kernel<true, false>"),
}


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


def kernel_rows(device) -> list:
    """[(label, fn)]: fn() launches one kernel on fixed inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for nq in (256, 512):
        r = Renderer(width=1920, height=1080, max_ray_depth=4, device=str(device))
        r.load_flat_scene(make_terrain_scene(nq))
        cs = r.bundle.cscene
        rnd = bk.random_rays(r, LANES, gen)
        camera, bounce, shadow = bk.wavefronts(r, LANES)
        any_hit = [(f"B_t{nq}_shadow_random", rnd["shadow"]), (f"B_t{nq}_shadow_blocked", shadow)]
        rows += [(label, lambda cs=cs, a=a: ic.tree_any_hit(cs, *a)) for label, a in any_hit]
        if cs.shade:
            closest = [("D_t256_camera_random", rnd["camera"]), ("D_t256_camera_blocked", camera),
                       ("D_t256_bounce_blocked", bounce)]
            rows += [(label, lambda cs=cs, a=a: ic.tree_closest_shade(cs, *a)) for label, a in closest]
        else:
            rows.append((f"A_t{nq}_camera_random", lambda cs=cs, a=rnd["camera"]: ic.tree_closest_hit(cs, *a)))
    return rows


def frame_profile(r: Renderer) -> dict:
    """frame_s of an untraced frame, then one traced frame's device time by kernel and busy share."""
    from torch.profiler import ProfilerActivity, profile

    r.render(progress=False)  # warm-up
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t0 = time.perf_counter()
    r.render(progress=False)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ic.KERNELS.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(progress=False)
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
    walk = {
        key: [sum(v[j] for name, v in by_name.items() if any(p in name for p in pats)) for j in (0, 1)]
        for key, pats in TRACE_NAMES.items()
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "frame_s": frame_s, "traced_s": traced_s, "launches": launches,
        "kernel_ms": sum(v[0] for v in by_name.values()), "kernel_launches": sum(v[1] for v in by_name.values()),
        "busy_share_traced": busy_us / 1e3 / (traced_s * 1e3),
        "D_ms": walk["D"][0], "D_calls": walk["D"][1], "B_ms": walk["B"][0], "B_calls": walk["B"][1],
        "top_kernels": [[name[:120], ms, n] for name, (ms, n) in top],
    }


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
        ptxas[tag] = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "spill" in ln]
    _build._lib = libs["C"]
    device = torch.device("cuda")
    rows = kernel_rows(device)
    r2 = config2_renderer(256, width=1920, height=1080, ns_aa=16, samples_per_batch=4)[0]
    smi = bk.nvidia_smi()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas}), flush=True)
    first, steps = {}, []
    for tag in ORDER:
        _build._lib = libs[tag]
        step = {"step": tag}
        for label, fn in rows:
            got = fn()
            torch.cuda.synchronize()
            if label in first:
                assert all(torch.equal(x, y) for x, y in zip(got, first[label])), f"{tag}: {label} differs"
            else:
                first[label] = got
            step[label] = bk.cuda_ms(fn, REPEATS)
            t0 = time.perf_counter()
            for _ in range(REPEATS):
                fn()
            step[f"{label}_host"] = (time.perf_counter() - t0) * 1e3 / REPEATS
            torch.cuda.synchronize()
        step["config2_frame"] = frame_profile(r2)
        steps.append(step)
        print(json.dumps(step), flush=True)
    _build._lib = libs["C"]
    artifact = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas, "lanes": LANES,
                "repeats": REPEATS, "steps": steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
