"""Eager against compiled frames on the card, in one process.

    python -m lens_flare_tpu_torch.ab_compiled [--out PATH] [--frames a,b,...]

Each frame is first rendered under ``compiled.disabled()`` (eager, one
launch per op) and then through its captured programs (``compiled.py``),
and :func:`compare` holds the two bit for bit (film, counts, the flared
film, rays, tests, skipped); a ghost buffer is compared bit for bit and
the finding reported, beside its moments per channel, held within
``flare.moments.GHOST_F32``.  Their launch counts
must be equal, and equal to the kernels that ``torch.profiler`` sees in
a replayed frame: a replay counts what its capture recorded, and the
trace shows that the graph launched just that.  It reports capture s
(the first compiled frame's warm-up, captures and instantiation, host
clock), both frames' seconds, the peak device MiB above the frame's
start with and without capture, and the replayed frame's busy share.
Then the steps alternate, eager, compiled, compiled,
eager (``ORDER``), each frame under ``ab_walk.frame_profile``: one
untraced steady frame (``frame_s``), then a traced one: device ms and
launches, busy share, top kernels.  The frames:

- ``terrain_1080p`` (``chip_smoke.py`` phase 3: render and flare composite);
- ``config2_frame`` (phase 5, adaptive, kernel D);
- ``env_1080p`` (phase 17: terrain 256's file under a 4096x2048 sky);
- ``dae_small`` (phase 8: the Cornell box, 320x240, 16 spp, depth 5);
- ``past_capacity`` (phase 11: 16,785,218 triangles through kernel G);
- ``ghost_realistic`` and ``ghost_paraxial``: env_1080p's flare pipeline's
  two ghost buffers.

It prints one JSON line per step and writes them all, with the card's
``nvidia-smi`` line, to ``--out`` (default ``_build/ab_compiled.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import bench_kernels as bk
from . import compiled
from .ab_bvh import PAST_CAPACITY_QUADS
from .ab_walk import TRACE_NAMES, config2_renderer, frame_profile, terrain_1080p
from .flare.moments import GHOST_F32, buffer_moments, ghost_errors
from .ops import intersect_cuda as ic
from .renderer import Renderer
from .scene.writer import cornell_box, sky_map, terrain_dae

ORDER = "ECCE"  # E eager (compiled.disabled()), C compiled
BUILD = Path(__file__).resolve().parent / "_build"
DEFAULT_OUT = BUILD / "ab_compiled.json"
FRAMES = ("terrain_1080p", "config2_frame", "env_1080p", "dae_small", "past_capacity",
          "ghost_realistic", "ghost_paraxial")


def _stats(r):
    st = r.stats
    return [st.total_rays, st.total_isects, st.total_zero_skipped, list(st.active_per_stage)]


def _capture_s(r):
    return r._programs.capture_s + r._flare_programs.capture_s


def _timed(frame):
    """(outputs, seconds, launches, peak MiB above the start) of one synchronized frame()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    t0 = time.perf_counter()
    out = frame()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, compiled.launch_counts(), (torch.cuda.max_memory_allocated() - mem0) / 2**20


def compare(r, frame, ghosts=None) -> dict:
    """Eager against compiled on ``r``'s ``frame()`` (before anything of ``r`` was captured).

    ``frame()`` returns tensors, film and counts first; every one of them
    (a flared film after the two too) must equal bit for bit, as must
    ``r``'s stats and the launch counts.  ``ghosts``: the frame is a ghost
    buffer whose sun sits at ``ghosts`` (the pipeline's ``axis_ray``): it
    is compared bit for bit and ``bit_equal`` says what was found, and its
    moments per channel (energy, centroid, radius), a diagnostic kept
    beside it, are held within ``GHOST_F32``.  Each kernel's launches in the replayed frames
    (the count its capture recorded, added per replay) must equal the
    eager frame's and the calls of it in a profiled replayed frame
    (``frame_profile``; a trace short of them, which the profiler's lost
    records can make, is taken again up to twice and kept in
    ``short_traces``).  Returns the numbers of the ``compiled`` row.
    """
    with compiled.disabled():
        frame()  # warm-up: cuFFT plans, the allocator, first launches
        want, eager_s, eager_launches, eager_mib = _timed(frame)
        want_stats = _stats(r)
    c0 = _capture_s(r)
    got, first_s, first_launches, capture_mib = _timed(frame)
    capture_s = _capture_s(r) - c0
    assert capture_s > 0 and len(r._programs) + len(r._flare_programs) > 0, "nothing was captured"
    again, frame_s, launches, _ = _timed(frame)
    want, got, again = (x if isinstance(x, tuple) else (x,) for x in (want, got, again))
    bit_equal = all(torch.equal(a, b) for out in (got, again) for a, b in zip(out, want))
    if ghosts is None:
        for name, out in (("first", got), ("steady", again)):
            assert all(torch.equal(a, b) for a, b in zip(out, want)), f"the {name} compiled frame differs"
        assert _stats(r) == want_stats, (_stats(r), want_stats)
        worst = None
    else:
        m_want = buffer_moments(want[0], ghosts)
        worst = {}
        for out in (got, again):
            for measure, errs in ghost_errors(buffer_moments(out[0], ghosts), m_want).items():
                worst[measure] = max(worst.get(measure, 0.0), max(errs.values()))
        assert all(worst[k] <= limit for k, limit in GHOST_F32.items()), worst
    assert first_launches == launches == eager_launches, (first_launches, launches, eager_launches)
    # the trace shows what a replay's graphs ran.  The profiler loses a record now and then (a
    # dae_small trace showed 159 of 160 C launches, the frame bit-equal), never adds one: a trace
    # that shows fewer calls is taken again, twice at most, and one that shows more fails
    counted, short = {k: launches[k] for k in TRACE_NAMES}, []
    for _ in range(3):
        prof = frame_profile(frame)
        traced = {k: prof[f"{k}_calls"] for k in TRACE_NAMES}
        assert {k: prof["launches"][k] for k in TRACE_NAMES} == counted, (prof["launches"], counted)
        assert all(traced[k] <= counted[k] for k in counted), ("a replay ran more launches than counted", traced, counted)
        if traced == counted:
            break
        short.append(traced)
    else:
        raise AssertionError(("three traces of a replayed frame showed fewer launches than counted", short, counted))
    return {
        "capture_s": capture_s, "first_s": first_s, "eager_s": eager_s, "frame_s": frame_s,
        "programs": len(r._programs) + len(r._flare_programs), "launches": launches,
        "eager_peak_mib": eager_mib, "capture_peak_mib": capture_mib,
        "bit_equal": bit_equal, "ghost_worst": worst, "traced_launches": traced, "short_traces": short,
        "busy_share": prof["busy_share_traced"], "kernel_ms": prof["kernel_ms"],
        "device_launches": prof["kernel_launches"],
        "trace_kernel_ms": {k: round(prof[f"{k}_ms"], 3) for k in TRACE_NAMES if traced[k]},
        "top_kernels": [[n[:90], round(ms, 3), c] for n, ms, c in prof["top_kernels"]],
    }


def frames(names=FRAMES) -> dict:
    """{name: (renderer, frame, ghost axis or None)} for the frames of ``names``, built on the card."""
    from .utils import exr

    out = {}
    if "terrain_1080p" in names:
        r, _, frame = terrain_1080p("cuda")
        out["terrain_1080p"] = (r, frame, None)
    if "config2_frame" in names:
        r2 = config2_renderer(256, "cuda", width=1920, height=1080, ns_aa=16, samples_per_batch=4)[0]
        out["config2_frame"] = (r2, lambda: r2.render(progress=False), None)
    BUILD.mkdir(parents=True, exist_ok=True)
    if {"env_1080p", "ghost_realistic", "ghost_paraxial"} & set(names):
        from .lens.aperture import ApertureTexture, polygon_mask

        terrain = terrain_dae(256).write(BUILD / "ab_terrain256.dae")
        sky = BUILD / "ab_sky.exr"
        exr.write(sky, sky_map(4096, 2048), pixel_type=exr.PIXELTYPE_HALF)
        if "env_1080p" in names:
            renv = Renderer(device="cuda", width=1920, height=1080, max_ray_depth=4, indirect=True,
                            envmap=exr.read(sky))
            renv.load(terrain)
            out["env_1080p"] = (renv, lambda: renv.render(progress=False), None)
        for model in ("realistic", "paraxial"):
            if f"ghost_{model}" in names:
                rg = Renderer(device="cuda", width=1920, height=1080, lens_model=model,
                              ghost_aperture=ApertureTexture.from_array(polygon_mask(64, 6)))
                rg.load(terrain)
                pipe = rg.flare_pipeline()
                assert pipe is not None and pipe.lens_model == model, "the terrain's sun must be on screen"
                out[f"ghost_{model}"] = (rg, pipe.ghost_buffer, pipe.axis_ray)
    if "dae_small" in names:
        rd = Renderer(device="cuda", width=320, height=240, ns_aa=16, max_ray_depth=5, indirect=True, seed=0)
        rd.load(cornell_box().write(BUILD / "ab_cornell.dae"))
        out["dae_small"] = (rd, lambda: rd.render(progress=False), None)
    if "past_capacity" in names:
        from .scene.procedural import make_terrain_scene

        rp = Renderer(width=1920, height=1080, ns_aa=1, max_ray_depth=1, seed=0, device="cuda")
        rp.load_flat_scene(make_terrain_scene(PAST_CAPACITY_QUADS))
        out["past_capacity"] = (rp, lambda: rp.render(progress=False), None)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--frames", default=",".join(FRAMES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B measures frames on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = args.frames.split(",")
    built = frames(names)
    smi = bk.nvidia_smi()
    rows = {}
    for name in names:
        r, frame, ghosts = built[name]
        rows[name] = compare(r, frame, ghosts)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "compiled": rows}), flush=True)
    steps = []
    for tag in ORDER:
        step = {"step": tag}
        for name in names:
            frame = built[name][1]
            if tag == "E":
                with compiled.disabled():
                    step[name] = frame_profile(frame)
            else:
                step[name] = frame_profile(frame)
        steps.append(step)
        print(json.dumps(step), flush=True)
    artifact = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "compiled": rows, "steps": steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
