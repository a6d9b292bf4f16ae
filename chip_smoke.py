#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises, so the script exits non-zero and prints no result):

0. the device: torch's name for it, and name and power limit from nvidia-smi;
1. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on terrain
   scenes of 128, 3,200 and 524,288 triangles with camera, bounce and
   shadow rays, plus each one's time beside the plain version's at 64k lanes;
3. the slice: the 1920x1080 frame of the 524,288-triangle terrain at 1 spp,
   depth 4, NEE and RR bounces, then the paraxial flare composite, written
   as a PNG; launch counts show the frame went through kernels A and B;
4. a 320x240 frame of the 128-triangle terrain, which traces its shadow
   rays with kernel C, held against the same frame rendered on the CPU.

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

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"A": 0.0, "B": 0.0, "C": 0.0}
    times = {}
    for nq in (8, 40, 512):
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
        report = {}
        for key, kind_rays, kernel, plain in runs:
            args = rays[kind_rays]
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err, exact = compare(got, want)
            errs[key] = max(errs[key], err)
            report[f"{key}_{kind_rays}"] = f"err={err:.3g},exact={exact},hits={int((got[1] >= 0).sum())}"
            # the main path's shapes: primary rays at 524k tris for A, shadow
            # rays at 524k tris for B, shadow rays of the small scene for C
            if (key, kind_rays, nq) in (("A", "camera", 512), ("B", "shadow", 512), ("C", "shadow", 8)):
                times[key] = (
                    cuda_time_ms(lambda: kernel(*args), 20),
                    cuda_time_ms(lambda: plain(*args), 3),
                )
        shape = f"{cs.b1}x{cs.b2}x{cs.k}"
        phase("kernels", t0, tris=r.scene.num_triangles, tree=shape, brute=cs.brute,
              lanes=LANES, **report)
    for key, (ms, plain_ms) in times.items():
        print(f"[timing] kernel={key} lanes={LANES} ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)

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

    # -- 5. results --------------------------------------------------------
    count = {"A": launches["A"], "B": launches["B"], "C": small_launches["C"]}
    kernels = [
        {
            "name": ic.KERNELS[k].name, "route": "cuda", "source": ic.KERNEL_SOURCE,
            "replaces": ic.KERNELS[k].replaces, "launches": count[k],
            "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
        }
        for k in ("A", "B", "C")
    ]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
