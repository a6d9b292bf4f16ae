#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises, so the script exits non-zero and prints no result):

0. the device: torch's name for it, and name and power limit from nvidia-smi;
1. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on terrain
   scenes of 128, 3,200, 131,072 and 524,288 triangles with camera, bounce
   and shadow rays, plus each one's time beside the plain version's at 64k
   lanes; kernel D (closest hit plus shading rows, on the two mid-size
   scenes) is also held to kernel A's outputs and timed against A plus
   ``finalize_hit``'s row gather;
3. the slice: the 1920x1080 frame of the 524,288-triangle terrain at 1 spp,
   depth 4, NEE and RR bounces, then the paraxial flare composite, written
   as a PNG; launch counts show the frame went through kernels A and B;
4. a 320x240 frame of the 128-triangle terrain, which traces its shadow
   rays with kernel C, held against the same frame rendered on the CPU;
5. config2_frame: the thin-lens octagon-bokeh adaptive render (ns_aa 16,
   stages of 4, 4 and 8 samples) of the 131,072-triangle terrain at
   1920x1080, focused by autofocus; its closest hits go through kernel D;
6. config2_small: the same settings at 320x240 (ns_aa 8) on the
   3,200-triangle terrain, held against the same frame rendered on the CPU.

The last line is {"ok": true, "device": {...}}; before it come the card's
nvidia-smi line and a JSON line with every kernel's numbers.  TF32 is off
for matrix products and convolutions: the ghost products are float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LANES = 1 << 16  # wavefront width of the main path (Renderer.tile_pixels)


def phase(title, t0, **numbers):
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{title}] {fields} seconds={time.perf_counter() - t0:.3f}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, repeats):
    """Mean device time of fn() over ``repeats`` calls, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def make_rays(r, n, gen):
    """Camera, bounce and shadow rays (with dead lanes) for a built Renderer."""
    import torch

    from lens_flare_tpu_torch.integrator.path import EPS_F, _offset_origin, trace_closest
    from lens_flare_tpu_torch.scene.camera import camera_params, generate_rays

    dev = torch.device(r.device)
    cam = camera_params(r.camera, dev)
    x = torch.rand(n, device=dev, generator=gen)
    y = torch.rand(n, device=dev, generator=gen)
    o, d = generate_rays(cam, x, y)
    o = o.contiguous()
    cam_rays = (o, d, cam.n_clip.expand(n).contiguous(), cam.f_clip.expand(n).contiguous())
    hit, _ = trace_closest(r.bundle, *cam_rays)
    p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]
    nrm = torch.where(hit.hit[:, None], hit.n, torch.tensor([0.0, 0.0, 1.0], device=dev))
    w = torch.nn.functional.normalize(nrm + torch.nn.functional.normalize(
        torch.randn(n, 3, device=dev, generator=gen), dim=1), dim=1)
    eps = torch.full((n,), EPS_F, device=dev)
    bounce = (_offset_origin(p, nrm, w), w, eps, torch.where(hit.hit, 1e30, 0.0))
    # shadow rays: toward the sun on even lanes, along the bounce direction
    # on odd ones (so that some are occluded), ~30% dead lanes
    sun = r.bundle.lights.direction[0].expand(n, 3)
    odd = (torch.arange(n, device=dev) % 2 == 1)[:, None]
    s_dir = torch.where(odd, w, sun).contiguous()
    live = hit.hit & (torch.rand(n, device=dev, generator=gen) > 0.3)
    shadow = (_offset_origin(p, nrm, s_dir), s_dir, eps, torch.where(live, 1e30, 0.0))
    return {"camera": cam_rays, "bounce": bounce, "shadow": shadow}


def compare(got, want):
    """CPU-test tolerances (tests/test_torch_intersect.py); returns (max_abs_err, exact)."""
    import torch

    t_g, s_g, b_g, n_g = got
    t_w, s_w, b_w, n_w = want
    hit_g, hit_w = s_g >= 0, s_w >= 0
    both = hit_g & hit_w
    assert (hit_g == hit_w).float().mean().item() >= 0.999, "hit masks differ"
    assert ((s_g == s_w) | ~both).float().mean().item() >= 0.999, "slots differ"
    assert (n_g == n_w).float().mean().item() >= 0.999, "test counts differ"
    assert abs(int(n_g.sum()) - int(n_w.sum())) <= 1e-3 * max(int(n_w.sum()), 1)
    err = 0.0
    if both.any():
        rel_t = (t_g[both] - t_w[both]).abs() / t_w[both].abs()
        assert (rel_t <= 1e-5).float().mean().item() >= 0.99 and rel_t.max().item() <= 1e-4
        db = (b_g[both] - b_w[both]).abs().max().item()
        assert db <= 1e-4
        err = max((t_g[both] - t_w[both]).abs().max().item(), db)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    return err, exact


def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import lens_flare_tpu_torch  # noqa: F401  (fails outside a checkout)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", t0, name=json.dumps(kind), nvidia_smi=json.dumps(smi),
          torch=torch.__version__, cuda=torch.version.cuda, tf32="off")

    # -- 1. build ----------------------------------------------------------
    from lens_flare_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    phase("build", t0, library=so.name, compiled_now=bool(_build.build_log),
          nvcc_seconds=f"{_build.build_seconds:.3f}", ptxas=json.dumps(regs))

    # -- 2. kernels against their plain versions ---------------------------
    from lens_flare_tpu.scene.procedural import make_terrain_scene
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.renderer import Renderer

    from lens_flare_tpu_torch.ops.intersect import finalize_hit

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"A": 0.0, "B": 0.0, "C": 0.0, "D": 0.0}
    times = {}
    for nq in (8, 40, 256, 512):
        t0 = time.perf_counter()
        r = Renderer(width=1920, height=1080, max_ray_depth=4, device="cuda")
        r.load_flat_scene(make_terrain_scene(nq))
        cs = r.bundle.cscene
        rays = make_rays(r, LANES, gen)
        runs = [
            ("A", "camera", lambda o, d, a, b: ic.tree_closest_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False)),
            ("A", "bounce", lambda o, d, a, b: ic.tree_closest_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False)),
            ("B", "shadow", lambda o, d, a, b: ic.tree_any_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, True)),
        ]
        if cs.brute:
            runs += [
                ("C", "shadow", lambda o, d, a, b: ic.brute_hit(cs, o, d, a, b),
                 lambda o, d, a, b: ic.brute_plain(cs, o, d, a, b)),
                ("C", "camera", lambda o, d, a, b: ic.brute_hit(cs, o, d, a, b, any_hit=False),
                 lambda o, d, a, b: ic.brute_plain(cs, o, d, a, b, any_hit=False)),
            ]
        if cs.shade:
            runs += [
                ("D", kind_rays, lambda o, d, a, b: ic.tree_closest_shade(cs, o, d, a, b),
                 lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False, shade=True))
                for kind_rays in ("camera", "bounce")
            ]
        report = {}
        for key, kind_rays, kernel, plain in runs:
            args = rays[kind_rays]
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err, exact = compare(got[:4], want[:4])
            if key == "D":
                # rows equal on triangle hits, and each is the slot's own row
                tri = (got[1] >= 0) & (got[1] == want[1])
                assert torch.equal(got[4][tri], want[4][tri]), "D's rows differ from the plain version's"
                assert torch.equal(got[4][tri], cs.slot_shade[got[1][tri].long()])
                assert (got[4][got[1] < 0] == 0).all()
                # the same walk as kernel A at chunk batch 1
                a_out = ic.tree_closest_hit(cs, *args)
                assert all(torch.equal(x, y) for x, y in zip(got[:4], a_out)), "D's walk differs from A's"
                exact = exact and torch.equal(got[4], want[4])
            errs[key] = max(errs[key], err)
            report[f"{key}_{kind_rays}"] = f"err={err:.3g},exact={exact},hits={int((got[1] >= 0).sum())}"
            # the main path's shapes: primary rays at 524k tris for A, shadow
            # rays at 524k tris for B, shadow rays of the small scene for C,
            # primary rays at 131k tris for D (config2_frame's scene)
            if (key, kind_rays, nq) in (
                ("A", "camera", 512), ("B", "shadow", 512), ("C", "shadow", 8), ("D", "camera", 256),
            ):
                times[key] = (
                    cuda_time_ms(lambda: kernel(*args), 20),
                    cuda_time_ms(lambda: plain(*args), 3),
                )
        if cs.shade and nq == 256:
            # D with its rows against A plus finalize_hit's row gather, to the Hit
            o, d, a, b = rays["camera"]

            def a_gather():
                return finalize_hit(r.bundle.scene, o, d, *ic.intersect(cs, o, d, a, b)[:5])

            def d_rows():
                t, prim, b1, b2, hit, _, rows = ic.intersect(cs, o, d, a, b, return_shade=True)
                return finalize_hit(r.bundle.scene, o, d, t, prim, b1, b2, hit, shade_rows=rows)

            hit_a, hit_d = a_gather(), d_rows()
            assert all(torch.equal(x, y) for x, y in zip(hit_a, hit_d)), "D's Hit differs from A's"
            times["A+gather"] = (cuda_time_ms(a_gather, 20), cuda_time_ms(d_rows, 20))
        shape = f"{cs.b1}x{cs.b2}x{cs.k}"
        phase("kernels", t0, tris=r.scene.num_triangles, tree=shape, brute=cs.brute,
              shade=cs.shade, lanes=LANES, **report)
    for key in ("A", "B", "C", "D"):
        ms, plain_ms = times[key]
        print(f"[timing] kernel={key} lanes={LANES} ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    a_gather_ms, d_rows_ms = times["A+gather"]
    print(f"[timing] tris=131072 lanes={LANES} camera rays to Hit: "
          f"A+finalize_hit_gather_ms={a_gather_ms:.4f} D+finalize_hit_rows_ms={d_rows_ms:.4f} "
          f"D_ms={times['D'][0]:.4f} D_plain_ms={times['D'][1]:.4f}", flush=True)

    # -- 3. the slice: the 1080p terrain frame with the flare --------------
    from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
    from lens_flare_tpu_torch.utils import image as img

    t0 = time.perf_counter()
    r = Renderer(
        width=1920, height=1080, ns_aa=1, max_ray_depth=4, ns_area_light=1, indirect=True,
        seed=0, flare_intensity=1.5, flare_radius=30.0, device="cuda",
        aperture=ApertureTexture.from_array(polygon_mask(256, 5, rotation=0.3)),
        ghost_aperture=ApertureTexture.from_array(polygon_mask(64, 6)),
    )
    r.load_flat_scene(make_terrain_scene(512))
    pipeline = r.flare_pipeline()
    assert pipeline is not None, "the terrain's sun must project on screen"
    pipeline.starburst()  # aperture FFT cached outside the timed frame, as bench.py does

    def frame():
        hdr, counts = r.render(progress=False)
        return hdr, counts, pipeline.composite(hdr)

    frame()  # warm-up: cuFFT plans, allocator, first launches
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    hdr, counts, out = frame()
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t_frame
    launches = {k: v.launches for k, v in ic.KERNELS.items()}
    comp_ms = cuda_time_ms(lambda: pipeline.composite(hdr), 5)
    st = r.stats
    assert out.shape == (1080, 1920, 3) and torch.isfinite(out).all(), "frame is not finite"
    assert (out >= hdr).all(), "the flare darkened a pixel"
    assert (out - hdr).sum() > 0 and hdr.sum() > 0 and (counts == 1).all()
    assert launches["A"] > 0 and launches["B"] > 0, f"main path skipped a kernel: {launches}"
    png = ROOT / "lens_flare_tpu_torch" / "_build" / "terrain_1080p.png"
    img.save_hdr_png(png, out.cpu().numpy(), flip_y=True)
    phase(
        "frame", t0, tris=r.scene.num_triangles, width=1920, height=1080, spp=1, depth=4,
        frame_s=f"{frame_s:.4f}", rays_traced=st.total_rays,
        mrays_traced_per_s=f"{st.total_rays / frame_s / 1e6:.3f}",
        zero_rays_skipped=st.total_zero_skipped, isects_per_ray=f"{st.isects_per_ray:.2f}",
        flare_composite_s=f"{comp_ms / 1e3:.4f}", bvh_build_s=f"{st.bvh_build_time:.2f}",
        launches=json.dumps(launches), png=png.name,
    )

    # -- 4. small frame through kernel C, held against the CPU render ------
    t0 = time.perf_counter()
    small = dict(width=320, height=240, ns_aa=1, max_ray_depth=4, indirect=True, seed=0)
    rs = Renderer(device="cuda", **small)
    rs.load_flat_scene(make_terrain_scene(8))
    ic.reset_launch_counts()
    got, _ = rs.render(progress=False)
    torch.cuda.synchronize()
    small_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert small_launches["C"] > 0, f"the small frame skipped kernel C: {small_launches}"
    rc = Renderer(device="cpu", **small)
    rc.load_flat_scene(make_terrain_scene(8))
    want, _ = rc.render(progress=False)
    got = got.cpu().double()
    want = want.double()
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and ok >= 0.99 and rel < 1e-3, (ok, rel)
    assert rs.stats.total_rays == rc.stats.total_rays
    phase("small_frame", t0, tris=rs.scene.num_triangles, width=320, height=240,
          pixels_within_tol=f"{ok:.5f}", mean_rel_diff=f"{rel:.3g}",
          rays_traced=rs.stats.total_rays, launches=json.dumps(small_launches))

    # -- 5. config2_frame: thin-lens bokeh adaptive render through kernel D -
    import numpy as np

    def config2(nq, **kw):
        """A cuda Renderer with the thin-lens octagon-bokeh settings, focused at the centre."""
        scene = make_terrain_scene(nq)
        settings = dict(
            max_tolerance=0.05, max_ray_depth=4, ns_area_light=1, indirect=True, seed=0,
            lens_radius=0.01 * float(np.linalg.norm(scene.bbox_max - scene.bbox_min)),
            bokeh=ApertureTexture.from_array(polygon_mask(500, 8)), **kw,
        )
        rr = Renderer(device="cuda", **settings)
        rr.load_flat_scene(scene)
        focal = rr.autofocus(rr.width / 2, rr.height / 2)
        assert 0 < focal < rr.camera.f_clip, f"autofocus missed the scene: {focal}"
        return rr, settings

    t0 = time.perf_counter()
    r2, _ = config2(256, width=1920, height=1080, ns_aa=16, samples_per_batch=4)
    assert r2.bundle.cscene.shade and not r2.bundle.cscene.stream
    r2.render(progress=False)  # warm-up
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    hdr2, counts2 = r2.render(progress=False)
    torch.cuda.synchronize()
    frame2_s = time.perf_counter() - t_frame
    c2_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    st2 = r2.stats
    assert c2_launches["D"] > 0 and c2_launches["A"] == 0 and c2_launches["B"] > 0, c2_launches
    assert hdr2.shape == (1080, 1920, 3) and torch.isfinite(hdr2).all() and hdr2.sum() > 0
    assert counts2.min().item() >= 4 and counts2.max().item() <= 16
    hist2 = {n: int((counts2 == n).sum()) for n in (4, 8, 16)}
    assert sum(hist2.values()) == 1920 * 1080, hist2
    png2 = ROOT / "lens_flare_tpu_torch" / "_build" / "config2_1080p.png"
    img.save_hdr_png(png2, hdr2.cpu().numpy(), flip_y=True)
    assert png2.stat().st_size > 0
    phase(
        "config2_frame", t0, tris=r2.scene.num_triangles, width=1920, height=1080, ns_aa=16,
        stages="4,4,8", depth=4, lens_radius=f"{r2.lens_radius:.6g}",
        focal_distance=f"{r2.focal_distance:.6g}", frame_s=f"{frame2_s:.4f}",
        rays_traced=st2.total_rays, mrays_traced_per_s=f"{st2.total_rays / frame2_s / 1e6:.3f}",
        isects_per_ray=f"{st2.isects_per_ray:.2f}", zero_rays_skipped=st2.total_zero_skipped,
        active_after_stage=json.dumps(st2.active_per_stage),
        mean_spp=f"{counts2.double().mean().item():.4f}", counts_hist=json.dumps(hist2),
        launches=json.dumps(c2_launches), png=png2.name,
    )

    # -- 6. config2_small: the same settings, held against the CPU render --
    t0 = time.perf_counter()
    rs2, small2 = config2(40, width=320, height=240, ns_aa=8, samples_per_batch=2)
    ic.reset_launch_counts()
    got, got_counts = rs2.render(progress=False)
    torch.cuda.synchronize()
    s2_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert s2_launches["D"] > 0, f"config2_small skipped kernel D: {s2_launches}"
    rc2 = Renderer(device="cpu", **small2)
    rc2.load_flat_scene(make_terrain_scene(40))
    focal_cpu = rc2.autofocus(160, 120)
    assert abs(focal_cpu - rs2.focal_distance) <= 1e-6 * rs2.focal_distance, (focal_cpu, rs2.focal_distance)
    rc2.focal_distance = rc2.camera.focal_distance = rs2.focal_distance  # identical inputs
    want, want_counts = rc2.render(progress=False)
    same_counts = (got_counts.cpu() == want_counts).double().mean().item()
    got = got.cpu().double()
    want = want.double()
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and same_counts >= 0.995 and ok >= 0.99 and rel < 1e-3, (
        same_counts, ok, rel)
    phase("config2_small", t0, tris=rs2.scene.num_triangles, width=320, height=240, ns_aa=8,
          counts_equal=f"{same_counts:.5f}", pixels_within_tol=f"{ok:.5f}",
          mean_rel_diff=f"{rel:.3g}", rays_traced=rs2.stats.total_rays,
          rays_traced_cpu=rc2.stats.total_rays, launches=json.dumps(s2_launches))

    # -- 7. results --------------------------------------------------------
    # each kernel's launches from the main path that runs it
    count = {"A": launches["A"], "B": launches["B"], "C": small_launches["C"], "D": c2_launches["D"]}
    kernels = [
        {
            "name": ic.KERNELS[k].name, "route": "cuda", "source": ic.KERNEL_SOURCE,
            "replaces": ic.KERNELS[k].replaces, "launches": count[k],
            "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
        }
        for k in ("A", "B", "C", "D")
    ]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
