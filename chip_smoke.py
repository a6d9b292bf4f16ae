#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises, so the script exits non-zero and prints no result):

0. the device: torch's name for it, and name and power limit from nvidia-smi;
1. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on terrain
   scenes of 128, 3,200, 131,072 and 524,288 triangles with camera, bounce
   and shadow rays of random pixels, plus each one's time beside the plain
   version's at 64k lanes; B and D (the warp-per-ray walk) must equal their
   plain versions bit for bit on every set, and are also timed on the first
   64k pixels in the renderer's 32x32-block order (D camera and bounce on
   131,072 triangles, B shadow on 131,072 and 524,288) and B on the
   131,072-triangle shadow rays; kernel D (closest hit plus shading rows,
   on the two mid-size scenes) is also held to kernel A's outputs and timed
   against A plus ``finalize_hit``'s row gather; kernel F (the group walk, top_batch 2 and
   4, closest hit, any hit and shade) on the two mid-size scenes, exactly
   against its plain version and against A, B and D; kernel E (the
   coefficient walk) on the exact-fit trees of 8,192 and 32,768 triangles,
   exactly against its plain version and against A (hits and slots equal
   on all but at most 1 lane in 10,000, t within 1e-3 relative);
3. the slice: the 1920x1080 frame of the 524,288-triangle terrain at 1 spp,
   depth 4, NEE and RR bounces, then the paraxial flare composite, written
   as a PNG; launch counts show the frame went through kernels A and B;
4. a 320x240 frame of the 128-triangle terrain, which traces its shadow
   rays with kernel C, held against the same frame rendered on the CPU;
5. config2_frame: the thin-lens octagon-bokeh adaptive render (ns_aa 16,
   stages of 4, 4 and 8 samples) of the 131,072-triangle terrain at
   1920x1080, focused by autofocus; its closest hits go through kernel D;
6. config2_small: the same settings at 320x240 (ns_aa 8) on the
   3,200-triangle terrain, held against the same frame rendered on the CPU;
7. kernel_bench: ``python -m lens_flare_tpu_torch.bench_kernels`` at full
   width (262,144-lane wavefronts), the path that runs kernels E and F; its
   rows and launch counts, then every E and F call it timed (E on both
   exact-fit trees with primary and bounce rays; F at top_batch 2 and 4 on
   the bounce and shadow wavefronts) held exactly against its plain
   version, tests included, on the bench's own scenes and rays, with the
   bench's time beside the plain version's.

The last line is {"ok": true, "device": {...}}; before it come the card's
nvidia-smi line and a JSON line with every kernel's numbers: launches on
its path, the largest error against its plain version, its time, the
plain version's, and its bound (the larger of the FLOPs the function needs
over 67 TFLOP/s, the H100's float32 peak without tensor cores, and the least
bytes it must move over 3.35 TB/s; see :func:`bound`).  TF32 is off for
matrix products and convolutions: the ghost products are float32.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LANES = 1 << 16  # wavefront width of the main path (Renderer.tile_pixels)
BENCH_LANES = 1 << 18  # wavefront width of the kernel bench (E's and F's path)
PEAK_FLOPS = 67e12  # H100 SXM float32 without tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# FLOP per slot test, counted from intersect.cu: mt_terms (3 sub, 18 mul,
# 12 add/sub = 41 with the dots) plus batch_test (1 div, 3 mul, 1 add) for
# closest hit, plus occludes (6 mul, 1 add) for any hit; E's four 10-term
# dot products (76) plus batch_test.  Comparisons are not counted.
FLOP_PER_TEST = {"closest": 46, "any": 48, "mxu": 81}
LANE_BYTES = 32 + 20  # o, d, t_lo, t_hi in; t, slot, bary, tests out
# the least bytes a walk reads of the tree: a box's lo and hi (24 of its 32
# bytes), a triangle slot's p0, e1 and e2 (36 of 48), E's four 10-term rows
# of a slot's (4, 16) coefficients (160 of 256), a top's centre (E), and a
# hit slot's shading row (D and F's shade instance)
BOX_BYTES = 24
TRI_ROW_BYTES = 36
MXU_ROW_BYTES = 160
CENTER_BYTES = 12
SHADE_ROW_BYTES = 40
# (kernel, rays, terrain n_quads) of phase 2 that are timed -> their label;
# "random" rays are LANES random pixels of the 1920x1080 film, "blocked" the
# first LANES pixels in the renderer's 32x32-block order
TIMED = {
    ("A", "camera", 512): "A", ("B", "shadow", 512): "B", ("C", "shadow", 8): "C",
    ("D", "camera", 256): "D", ("A", "camera", 256): "A_vmem", ("C", "camera", 8): "C_closest",
    ("B", "shadow", 256): "B_t256",
    ("D", "camera_blocked", 256): "D_blocked_camera", ("D", "bounce_blocked", 256): "D_blocked_bounce",
    ("B", "shadow_blocked", 256): "B_blocked_t256", ("B", "shadow_blocked", 512): "B_blocked",
}
# the kernels line: each kernel at its PERF.md table shape, then D's and B's other timed shapes
LINE_CASES = {
    "A": "terrain512_camera_random", "B": "terrain512_shadow_random", "C": "terrain8_shadow_random",
    "D": "terrain256_camera_random", "E": "bench_terrain128_bounce", "F": "bench_terrain256_bounce_tb2",
    "B_t256": "terrain256_shadow_random", "D_blocked_camera": "terrain256_camera_blocked",
    "D_blocked_bounce": "terrain256_bounce_blocked", "B_blocked_t256": "terrain256_shadow_blocked",
    "B_blocked": "terrain512_shadow_blocked",
}
BLOCKED_SCENES = (256, 512)  # config2_frame's tree and terrain_1080p's


def phase(title, t0, **numbers):
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{title}] {fields} seconds={time.perf_counter() - t0:.3f}", flush=True)


def chunks_hit(cs, o, d, t_lo, t_hi) -> tuple[int, int]:
    """(tops, chunks) whose boxes at least one ray enters within [t_lo, t_hi]."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic

    inv = ic._safe_inv(d)
    if cs.b1 > 1:
        top_hits = ic._box_hits(cs.top, o, inv, t_lo, t_hi)
        tops = top_hits.any(dim=0).nonzero()[:, 0].tolist()
    else:
        top_hits, tops = None, [0]
    child = cs.child.view(cs.b1, cs.b2, 8)
    n_chunks = 0
    for tp in tops:
        lanes = top_hits[:, tp].nonzero()[:, 0] if top_hits is not None else slice(None)
        ch = ic._box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_hi[lanes])
        n_chunks += int(ch.any(dim=0).sum())
    return len(tops), n_chunks


def bound(cs, key, any_hit, rays, out, tests=None):
    """(bound_ms, bound_by) of one kernel call: max(FLOPs / peak, bytes / bandwidth).

    FLOPs: the summed ``tests`` times the FLOP per slot test.  ``tests``
    defaults to the call's own; F passes those of the default walk (A or B)
    on the same rays, which computes the same function with the clip fixed
    per top, so F's extra tests from the clip fixed per group are not work
    the function needs.  Bytes: every lane's rays and outputs once (D and
    F's shade instance: +40 for the rows), the top boxes, and the child boxes
    and slot rows of the chunks that the hits found require (a box a
    closest-hit ray enters before its hit, or an unoccluded shadow ray
    enters at all), each once, at the least size a walk reads (BOX_BYTES and
    the rest above), plus the shading rows of the slots hit.
    """
    import torch

    o, d, t_lo, t_hi = rays
    t, slot = out[0], out[1]
    tests = out[3] if tests is None else tests
    n = o.shape[0]
    shade = len(out) > 4
    kind = "mxu" if key == "E" else ("any" if any_hit else "closest")
    flops = float(tests.sum(dtype=torch.float64)) * FLOP_PER_TEST[kind]
    nbytes = n * (LANE_BYTES + (SHADE_ROW_BYTES if shade else 0))
    if key.startswith("C"):
        nbytes += cs.s_real * TRI_ROW_BYTES  # every real triangle row
    else:
        if kind == "any":
            live, clip = slot < 0, t_hi
        else:
            live, clip = torch.ones_like(slot, dtype=torch.bool), torch.minimum(t_hi, t)
        n_tops, n_chunks = chunks_hit(cs, o[live], d[live], t_lo[live], clip[live])
        row = MXU_ROW_BYTES if key == "E" else TRI_ROW_BYTES
        nbytes += BOX_BYTES * cs.b1 + BOX_BYTES * cs.b2 * n_tops + row * cs.k * n_chunks
        if key == "E":
            nbytes += CENTER_BYTES * n_tops
        if shade:
            tri_slot = slot[(slot >= 0) & (slot < cs.b1 * cs.b2 * cs.k)]
            nbytes += SHADE_ROW_BYTES * int(torch.unique(tri_slot).numel())
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


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
    import numpy as np
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import lens_flare_tpu_torch  # noqa: F401  (fails outside a checkout)
    from lens_flare_tpu_torch import bench_kernels as bk

    kind = torch.cuda.get_device_name(0)
    smi = bk.nvidia_smi()
    assert smi, "nvidia-smi gave no name, power.limit line"
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
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.ops.intersect import finalize_hit
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {key: 0.0 for key in "ABCDEF"}
    times = {}
    bounds = {}
    for nq in (8, 40, 256, 512):
        t0 = time.perf_counter()
        r = Renderer(width=1920, height=1080, max_ray_depth=4, device="cuda")
        r.load_flat_scene(make_terrain_scene(nq))
        cs = r.bundle.cscene
        rays = bk.random_rays(r, LANES, gen)
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
        if nq in BLOCKED_SCENES:
            blocked = bk.wavefronts(r, LANES)
            rays.update({f"{kind}_blocked": w for kind, w in zip(("camera", "bounce", "shadow"), blocked)})
            runs.append(("B", "shadow_blocked", lambda o, d, a, b: ic.tree_any_hit(cs, o, d, a, b),
                         lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, True)))
        if cs.shade:
            kinds = ("camera", "bounce") + (("camera_blocked", "bounce_blocked") if nq in BLOCKED_SCENES else ())
            runs += [
                ("D", kind_rays, lambda o, d, a, b: ic.tree_closest_shade(cs, o, d, a, b),
                 lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False, shade=True))
                for kind_rays in kinds
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
            if key in ("B", "D"):  # the warp walk gives its plain version's outputs bit for bit
                assert exact, f"{key} differs from its plain version: terrain{nq} {kind_rays}"
            errs[key] = max(errs[key], err)
            report[f"{key}_{kind_rays}"] = f"err={err:.3g},exact={exact},hits={int((got[1] >= 0).sum())}"
            # the main path's shapes: primary rays at 524k tris for A (the
            # JAX package's stream mode, PERF.md row 2), shadow rays at 524k
            # tris for B, shadow rays of the small scene for C, primary rays
            # at 131k tris for D (config2_frame's scene), B's shadow rays
            # there, and D's and B's blocked-order wavefronts; and two rows
            # no path runs by default: A on the 131k VMEM-mode tree (row 1)
            # and C's closest-hit flag (row 5)
            label = TIMED.get((key, kind_rays, nq))
            if label:
                times[label] = (
                    bk.cuda_ms(lambda: kernel(*args), 20),
                    bk.cuda_ms(lambda: plain(*args), 3),
                )
                bounds[label] = bound(cs, key, kind_rays.startswith("shadow"), args, got)
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
            times["A+gather"] = (bk.cuda_ms(a_gather, 20), bk.cuda_ms(d_rows, 20))
        if nq in (40, 256):
            # F, the group walk: exactly its plain version, and A's, B's or
            # D's t, slot, bary, hit and rows; only the tests differ
            assert cs.b1 > 1 and not cs.stream and cs.shade
            for tb in (2, 4):
                for kind_rays, any_hit, shade in (
                    ("camera", False, False), ("bounce", False, False), ("shadow", True, False),
                    ("bounce", False, True),
                ):
                    args = rays[kind_rays]
                    got = ic.tree_group(cs, *args, tb, any_hit=any_hit, shade=shade)
                    torch.cuda.synchronize()
                    want = ic.tree_plain(cs, *args, any_hit, shade=shade, top_batch=tb)
                    err, _ = compare(got[:4], want[:4])
                    exact = all(torch.equal(g, w) for g, w in zip(got, want))
                    assert exact, f"F differs from its plain version: {nq} tb={tb} {kind_rays} shade={shade}"
                    walk = ic.tree_closest_shade if shade else (ic.tree_any_hit if any_hit else ic.tree_closest_hit)
                    ref = walk(cs, *args)
                    assert all(torch.equal(g, w) for j, (g, w) in enumerate(zip(got, ref)) if j != 3), (
                        f"F's hits differ from the default walk's: {nq} tb={tb} {kind_rays} shade={shade}")
                    errs["F"] = max(errs["F"], err)
                    tag = f"F{tb}_{kind_rays}" + ("_shade" if shade else "")
                    report[tag] = f"exact={exact},tests={int(got[3].sum())}/{int(ref[3].sum())}"
        shape = f"{cs.b1}x{cs.b2}x{cs.k}"
        phase("kernels", t0, tris=r.scene.num_triangles, tree=shape, brute=cs.brute,
              shade=cs.shade, lanes=LANES, **report)
    # E, the coefficient walk, on the exact-fit trees of tools/ab_mxu_mt.py
    from lens_flare_tpu_torch.accel.wide import build_wide_bvh

    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    for nq, shape in bk.MXU_SCENES:
        t0 = time.perf_counter()
        scene = make_terrain_scene(nq)
        cs = ic.CudaScene.from_wide_bvh(build_wide_bvh(scene.tri_p, *shape), *none, scene.num_triangles,
                                        "cuda", mxu=True)
        report = {}
        for kind_rays, args in bk.mxu_rays(scene, LANES, "cuda").items():
            got = ic.tree_closest_mxu(cs, *args)
            torch.cuda.synchronize()
            want = ic.tree_plain(cs, *args, False, mxu=True)
            err, exact = compare(got, want)
            assert exact, f"E differs from its plain version: terrain{nq} {kind_rays}"
            # against A: E's affine forms round otherwise than A's cross
            # products, so a grazing ray may flip (<= 1 lane in 10,000), and
            # t agrees to 1e-3 relative (the cancellation the per-top
            # re-centring bounds), as tests/test_pallas.py holds the two walks
            a_out = ic.tree_closest_hit(cs, *args)
            hit, hit_a = got[1] >= 0, a_out[1] >= 0
            both = hit & hit_a & (got[1] == a_out[1])
            n_hit_diff = int((hit != hit_a).sum())
            n_slot_diff = int((hit & hit_a).sum()) - int(both.sum())
            assert n_hit_diff + n_slot_diff <= 1e-4 * hit.numel(), ("E's hits differ from A's", n_hit_diff, n_slot_diff)
            t_rel = ((got[0][both] - a_out[0][both]).abs() / a_out[0][both].abs()).max().item() if both.any() else 0.0
            assert t_rel <= 1e-3, t_rel
            errs["E"] = max(errs["E"], err)
            report[f"E_{kind_rays}"] = (f"exact={exact},hits={int(hit.sum())},vs_A_hit_diff={n_hit_diff},"
                                        f"slot_diff={n_slot_diff},t_maxrel={t_rel:.3g}")
        phase("kernels_mxu", t0, tris=scene.num_triangles, tree="x".join(map(str, shape)), lanes=LANES, **report)
    for label in TIMED.values():
        (ms, plain_ms), (b_ms, b_by) = times[label], bounds[label]
        print(f"[timing] kernel={label} lanes={LANES} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} bound_by={b_by}", flush=True)
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
    comp_ms = bk.cuda_ms(lambda: pipeline.composite(hdr), 5)
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
    from lens_flare_tpu_torch.ab_walk import config2_renderer

    t0 = time.perf_counter()
    r2, _ = config2_renderer(256, "cuda", width=1920, height=1080, ns_aa=16, samples_per_batch=4)
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
    rs2, small2 = config2_renderer(40, "cuda", width=320, height=240, ns_aa=8, samples_per_batch=2)
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

    # -- 7. kernel_bench: the path of kernels E and F ----------------------
    t0 = time.perf_counter()
    bench_out = ROOT / "lens_flare_tpu_torch" / "_build" / "bench_kernels.json"
    cases = []
    ic.reset_launch_counts()
    art = bk.main(["--n", str(BENCH_LANES), "--out", str(bench_out)], cases=cases)
    torch.cuda.synchronize()
    bench_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert bench_launches["E"] > 0 and bench_launches["F"] > 0, f"the bench skipped E or F: {bench_launches}"
    assert all(row["ok"] for row in art["rows"] if "check" in row)
    # every E and F call the bench timed, on its own scenes and rays:
    # exactly the plain version, tests included; the bound counts F's work
    # from the default walk's tests on the same rays
    report = {}
    for c in cases:
        got = c.kernel()
        torch.cuda.synchronize()
        want = c.plain()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{c.key} differs from its plain version: {c.label}"
        err, _ = compare(got, want)
        errs[c.key] = max(errs[c.key], err)
        plain_ms = bk.cuda_ms(c.plain, 2)
        b_ms, b_by = bound(c.cs, c.key, c.any_hit, c.rays, got, tests=None if c.key == "E" else c.base_tests)
        # the kernels line takes E on terrain 128's bounce rays and F at
        # top_batch 2 on terrain 256's bounce wavefront
        if c.label in ("terrain128_bounce", "terrain256_bounce_tb2"):
            times[c.key], bounds[c.key] = (c.ms, plain_ms), (b_ms, b_by)
        report[f"{c.key}_{c.label}"] = f"exact=True,tests={int(got[3].sum())}/{int(c.base_tests.sum())}"
        print(f"[timing] kernel={c.key} case={c.label} lanes={c.rays[0].shape[0]} ms={c.ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} bound_by={b_by}", flush=True)
    assert "E" in times and "F" in times, sorted(c.label for c in cases)
    phase("kernel_bench", t0, rows=len(art["rows"]), lanes=BENCH_LANES, cases=len(cases),
          launches=json.dumps(bench_launches), artifact=bench_out.name, **report)

    # -- 8. results --------------------------------------------------------
    # each kernel's launches from the main path that runs it; B's rows on
    # terrain 256 count config2_frame's launches, where that tree is traced
    count = {"A": launches["A"], "B": launches["B"], "C": small_launches["C"], "D": c2_launches["D"],
             "E": bench_launches["E"], "F": bench_launches["F"]}
    count.update({label: c2_launches["B"] for label in ("B_t256", "B_blocked_t256")})
    kernels = [
        {
            "name": ic.KERNELS[label[0]].name, "case": case, "route": "cuda", "source": ic.KERNEL_SOURCE,
            "replaces": ic.KERNELS[label[0]].replaces, "launches": count.get(label, count[label[0]]),
            "max_abs_err": errs[label[0]], "ms": times[label][0], "plain_ms": times[label][1],
            "bound_ms": bounds[label][0], "bound_by": bounds[label][1],
            # no single PyTorch call computes a cluster-tree traversal
            "library_ms": None,
        }
        for label, case in LINE_CASES.items()
    ]
    print(bk.nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
