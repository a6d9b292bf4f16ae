"""Kernel bench: every trace kernel on terrain wavefronts, on the card.

    python -m lens_flare_tpu_torch.bench_kernels [--n 262144] [--scenes 8,256,512] [--out PATH] [--device cuda]

Counterpart of ``tools/bench_kernels.py`` with ``tools/ab_mxu_mt.py`` folded
in.  It prints one JSON row per measurement and writes them all, with the
card's name and its ``nvidia-smi`` name and power-limit line, to ``--out``
(default ``lens_flare_tpu_torch/_build/bench_kernels.json``):

- **default walk**: the primary, bounce and shadow wavefronts of the
  512x512 film (32x32 pixel blocks, cosine bounces from the port's
  threefry ``_rng``, shadow rays toward light 0) through ``intersect`` on
  terrains of 128, 131,072 and 524,288 triangles (terrain 8 stands in for
  the pyramid, whose ``.dae`` is absent): ms, Mrays/s, tests per live ray
  and the kernel that ran;
- **group walk** (kernel F): where the tree is multi-level and not streamed,
  ``top_batch`` 2 and 4 on the bounce (closest hit) and shadow (any hit)
  wavefronts, which must give the default walk's t, prim and hit exactly;
- **coefficient walk** (kernel E) against the classic walk (A) on the
  exact-fit trees of ``ab_mxu_mt.py``: terrain 64 as (8, 32, 32) and terrain
  128 as (32, 32, 32), camera rays over an isqrt(n)-square film and random
  bounces: base_ms, mxu_ms, speedup, hit_agree, prim_agree and t_maxrel;
- **vertex shading** (kernel I, on the card): I-a and I-b alone on a
  65,536-lane camera and bounce vertex of each terrain cell (I-a's diffuse
  instance) and of the Cornell cell (its general instance), their byte
  bound, the plain vertex functions' device time and the registers
  (:func:`bench_vertex`).

It runs on ``cuda`` and raises when there is no card.  ``--device cpu``
runs the plain versions for a functional check and measures no time
(``ms`` is null).  Times on the card are CUDA-event means of ``REPEATS``
calls after a warm-up, reported unrounded.  A caller that passes
``main(cases=[])`` gets every timed call of kernels E and F back as a
:class:`Case`, with its scene and rays, to check it again at these shapes.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import _rng
from .accel.wide import build_wide_bvh
from .integrator.path import EPS_F, _offset_origin, trace_closest
from .integrator.shading import local_to_world, make_coord_space
from .ops import intersect_cuda as ic
from .renderer import Renderer, blocked_order
from .scene.camera import Camera, camera_params, generate_rays
from .scene.procedural import make_terrain_scene

DEFAULT_OUT = Path(__file__).resolve().parent / "_build" / "bench_kernels.json"
FILM = 512  # the tool's 512x512 film
# (n_quads, tree shape) of ab_mxu_mt.py: exact fits, so the coefficient
# table holds no padding nodes
MXU_SCENES = ((64, (8, 32, 32)), (128, (32, 32, 32)))
REPEATS = 5  # timed calls per measurement
PEAK_FLOPS = 67e12  # H100 SXM float32 without tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# FLOP per slot test, counted from intersect.cu: mt_terms (3 sub, 18 mul,
# 12 add/sub = 41 with the dots) plus batch_test (1 div, 3 mul, 1 add) for
# closest hit, plus occludes (6 mul, 1 add) for any hit; E's first stage
# (CoefSlots::closest: the det and b1 dot products, 38, a division and a
# product) on every slot, and its second (the t and b2 dot products, two
# products and a sum) only where det != 0 and b1 lies in [0, 1].
# Comparisons are not counted.
FLOP_PER_TEST = {"closest": 46, "any": 48, "mxu": 40}
MXU_PASS_FLOP = 41
LANE_BYTES = 32 + 20  # o, d, t_lo, t_hi in; t, slot, bary, tests out
# the least bytes a walk reads of the tree: a box's lo and hi (24 of its 32
# bytes), a triangle slot's p0, e1 and e2 (36 of 48), half of E's packed
# 160-byte row (det and b1; t and b2 only for slots that pass them), a
# top's centre (E), and a hit slot's shading row (D and F's shade instance)
BOX_BYTES = 24
TRI_ROW_BYTES = 36
MXU_HALF_ROW_BYTES = 80
CENTER_BYTES = 12
SHADE_ROW_BYTES = 40
QUEUE_CYCLES = 50_000_000  # ~0.03 s of device sleep ahead of the timed calls


def nvidia_smi() -> str:
    """The card's ``name, power.limit`` line (empty where nvidia-smi is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_ms(fn, repeats: int = REPEATS):
    """Mean device milliseconds of fn() over ``repeats`` calls after one warm-up; None off the card.

    The timed calls are queued behind a device sleep of ``QUEUE_CYCLES``, so
    that they run back to back: a kernel shorter than its wrapper's host
    work (checks, output allocations, the launch, ~0.05 ms) would otherwise
    be timed at the host's pace.  A function that waits on the device itself
    (the plain versions) is timed as before.
    """
    if fn()[0].device.type != "cuda":
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def chunk_pairs(cs, o, d, t_lo, t_hi):
    """Per top that a ray enters within [t_lo, t_hi], ascending: (top, lanes, children) of its (lane, chunk) pairs entered."""
    inv = ic._safe_inv(d)
    if cs.b1 > 1:
        top_hits = ic._box_hits(cs.top, o, inv, t_lo, t_hi)
        tops = top_hits.any(dim=0).nonzero()[:, 0].tolist()
    else:
        top_hits, tops = None, [0]
    child = cs.child.view(cs.b1, cs.b2, 8)
    for tp in tops:
        lanes = top_hits[:, tp].nonzero()[:, 0] if top_hits is not None else torch.arange(o.shape[0], device=o.device)
        ch = ic._box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_hi[lanes])
        pl, pc = ch.nonzero(as_tuple=True)
        yield tp, lanes[pl], pc


def chunks_hit(cs, o, d, t_lo, t_hi) -> tuple[int, int]:
    """(tops, chunks) whose boxes at least one ray enters within [t_lo, t_hi]."""
    n_tops = n_chunks = 0
    for _, _, pc in chunk_pairs(cs, o, d, t_lo, t_hi):
        n_tops += 1
        n_chunks += int(torch.unique(pc).numel())
    return n_tops, n_chunks


def mxu_passes(cs, o, d, t_lo, t_hi, block: int = 1 << 14) -> tuple[int, int]:
    """Kernel E's second stage over the chunks rays enter within [t_lo, t_hi]: (tests, slots).

    A (lane, slot) pair passes E's first stage where det != 0 and b1 lies in
    [0, 1], computed as ``CoefSlots::closest`` computes them; returns the
    number of passing pairs and of slots with at least one.
    """
    k = cs.k
    coef = cs.mxu_coef.view(cs.b1, cs.b2, k, 4, 16)
    passed = torch.zeros(cs.b1 * cs.b2 * k, dtype=torch.bool, device=o.device)
    n_pass = 0
    for tp, gl, pc in chunk_pairs(cs, o, d, t_lo, t_hi):
        for i in range(0, gl.numel(), block):
            g, c = gl[i : i + block], pc[i : i + block]
            det, _, bb1_n, _ = ic._mxu_terms(coef[tp, c], ic._mxu_features(o[g], d[g], cs.mxu_centers[tp]))
            b1 = bb1_n * (1.0 / torch.where(det == 0, 1e-30, det))
            ok = (det != 0) & (b1 >= 0) & (b1 <= 1)  # (P, K)
            n_pass += int(ok.sum())
            ids = (tp * cs.b2 + c)[:, None] * k + torch.arange(k, device=o.device)
            passed[ids[ok]] = True
    return n_pass, int(passed.sum())


def brute_any_hit_tests(cs, o, d, t_lo, t_hi, tests, block: int = 1 << 13) -> tuple[torch.Tensor, int]:
    """Kernel C's any-hit tests cut to what the function needs: (tests per lane, triangle rows read).

    A live lane (t_hi > t_lo, in a tile the kernel walks, ``tests`` > 0)
    needs the triangles up to its first occluder in row order, then the
    sphere pass, whose slot lands in the output whether or not a triangle
    occludes; the rows read are those up to the last lane's need.
    """
    s = cs.s_real
    need = torch.full_like(tests, s)
    rows = cs.tri_brute[:s]
    for i in range(0, o.shape[0], block):
        sl = slice(i, i + block)
        terms = ic._mt_terms(rows[None], o[sl, None, :], d[sl, None, :])
        occ = ic._occludes(*terms, t_lo[sl, None], t_hi[sl, None])  # (L, S)
        first = torch.where(occ.any(dim=1), occ.int().argmax(dim=1) + 1, s)
        need[sl] = first.to(tests.dtype)
    walked = (t_hi > t_lo) & (tests > 0)
    cut = torch.where(walked, tests - (s - need), tests)
    return cut, int(need[walked].max()) if bool(walked.any()) else 0


def bound(cs, key, any_hit, rays, out, tests=None):
    """(bound_ms, bound_by) of one kernel call: max(FLOPs / peak, bytes / bandwidth).

    FLOPs: the summed ``tests`` times the FLOP per slot test.  ``tests``
    defaults to the call's own; F passes those of the default walk (A or B)
    on the same rays, which computes the same function with the clip fixed
    per top, so F's extra tests from the clip fixed per group are not work
    the function needs.  C's any hit counts each lane's tests up to its
    first occluder (:func:`brute_any_hit_tests`), and E adds its second
    stage's FLOP for the pairs that reach it (:func:`mxu_passes`).  Bytes:
    every lane's rays and outputs once (D and F's shade instance: +40 for
    the rows), C's triangle rows up to the last one a lane needs, the top
    boxes, and the child boxes and slot rows of the chunks that the hits
    found require (a box a closest-hit ray enters before its hit, or an
    unoccluded shadow ray enters at all), each once, at the least size a
    walk reads (BOX_BYTES and the rest above: for E, the first half of every
    such slot's row and the second half of the slots that pass), plus the
    shading rows of the slots hit.
    """
    o, d, t_lo, t_hi = rays
    t, slot = out[0], out[1]
    tests = out[3] if tests is None else tests
    n = o.shape[0]
    shade = len(out) > 4
    kind = "mxu" if key == "E" else ("any" if any_hit else "closest")
    nbytes = n * (LANE_BYTES + (SHADE_ROW_BYTES if shade else 0))
    extra_flops = 0.0
    if key.startswith("C"):
        n_rows = cs.s_real
        if any_hit:
            tests, n_rows = brute_any_hit_tests(cs, o, d, t_lo, t_hi, tests)
        nbytes += n_rows * TRI_ROW_BYTES
    else:
        if kind == "any":
            live, clip = slot < 0, t_hi
        else:
            live, clip = torch.ones_like(slot, dtype=torch.bool), torch.minimum(t_hi, t)
        walk = (o[live], d[live], t_lo[live], clip[live])
        n_tops, n_chunks = chunks_hit(cs, *walk)
        nbytes += BOX_BYTES * cs.b1 + BOX_BYTES * cs.b2 * n_tops
        if key == "E":
            n_pass, n_pass_slots = mxu_passes(cs, *walk)
            extra_flops = float(n_pass) * MXU_PASS_FLOP
            nbytes += MXU_HALF_ROW_BYTES * (cs.k * n_chunks + n_pass_slots) + CENTER_BYTES * n_tops
        else:
            nbytes += TRI_ROW_BYTES * cs.k * n_chunks
        if shade:
            tri_slot = slot[(slot >= 0) & (slot < cs.b1 * cs.b2 * cs.k)]
            nbytes += SHADE_ROW_BYTES * int(torch.unique(tri_slot).numel())
    flops = float(tests.sum(dtype=torch.float64)) * FLOP_PER_TEST[kind] + extra_flops
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# kernel G (the binary-BVH walk): per lane o, d, t_lo, t_hi in; t, prim,
# b1, b2, tests and the found byte out; per node its box (24 B) and links
# (16 B); per primitive tested its row and its prim_order entry.  The least
# work of the walk in the FlatBVH's terms, whatever layout a kernel reads.
G_LANE_BYTES = 32 + 21
G_NODE_BYTES = 24 + 16
G_SPHERE_BYTES = 16
BOX_TEST_FLOP = 25  # per axis 2 sub, 2 mul, min, max; 4 reductions; 3 compares


def bvh_bound(bv, rays, out, visits):
    """(bound_ms, bound_by) of one kernel G call, as :func:`bound` for the cluster walks.

    ``visits``: the plain version's record of the same call
    (``bvh_walk_plain(..., visits=)``): the nodes popped and primitives
    tested by any lane, each read once, and each lane's interior nodes,
    whose two child boxes it tests.  FLOPs: the call's tests times the FLOP
    of a closest-hit slot test, plus the box tests.
    """
    o = rays[0]
    tests = out[5]
    ids = bv.rows.view(torch.int32)[:, 11][visits["prims"]].long()  # the tested primitives' ids
    n_tri = int((ids < bv.num_tris).sum())
    nbytes = (o.shape[0] * G_LANE_BYTES + int(visits["nodes"].sum()) * G_NODE_BYTES
              + n_tri * (TRI_ROW_BYTES + 4) + (ids.numel() - n_tri) * (G_SPHERE_BYTES + 4))
    box_tests = o.shape[0] + 2 * float(visits["interior"].sum(dtype=torch.float64))
    flops = float(tests.sum(dtype=torch.float64)) * FLOP_PER_TEST["closest"] + box_tests * BOX_TEST_FLOP
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# kernel H (threefry): per draw 20 rounds of add, rotate and xor (60), five key injections of two
# adds (10), the counter's first two adds and the key's parity word (4), the words' xor and the float
# fill (shift, or, subtract, max: 5 with the xor): 79, taken as 80 32-bit operations at the card's
# int32 rate; per key its 16 bytes read once, per draw its word written.
THREEFRY_OPS_PER_DRAW = 80
PEAK_INT32_OPS = 132 * 64 * 1.98e9  # H100 SXM: 64 int32 lanes per SM and clock, 1,980 MHz boost


def rng_bound(n: int, u: int, out_bytes: int = 4):
    """(bound_ms, bound_by) of one kernel H draw of ``u`` words for each of ``n`` keys."""
    t_ops = n * u * THREEFRY_OPS_PER_DRAW / PEAK_INT32_OPS
    t_bytes = (n * 16 + n * u * out_bytes) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


@dataclass
class Case:
    """One timed call of kernel E or F, kept so that a caller can check it at the bench's shape."""

    key: str  # "E" (coefficient walk) or "F" (group walk)
    label: str  # scene, wavefront and top_batch
    cs: ic.CudaScene
    rays: tuple  # (o, d, t_lo, t_hi)
    any_hit: bool
    top_batch: int  # 1 for E
    ms: float | None  # the bench's time of the call
    base_tests: torch.Tensor  # per-lane tests of the default walk (A or B) on the same rays

    def kernel(self):
        if self.key == "E":
            return ic.tree_closest_mxu(self.cs, *self.rays)
        return ic.tree_group(self.cs, *self.rays, self.top_batch, any_hit=self.any_hit)

    def plain(self):
        return ic.tree_plain(self.cs, *self.rays, self.any_hit, mxu=self.key == "E", top_batch=self.top_batch)


def build_renderer(n_quads: int, device) -> Renderer:
    """The tool's Renderer (512x512, depth 4, indirect) on a terrain of 2 * n_quads^2 triangles."""
    r = Renderer(width=FILM, height=FILM, ns_aa=1, max_ray_depth=4, indirect=True, device=str(device))
    r.load_flat_scene(make_terrain_scene(n_quads))
    return r


def wavefronts(r: Renderer, n: int, seed: int = 0):
    """(primary, bounce, shadow) rays (o, d, t_lo, t_hi), as ``tools/bench_kernels._wavefronts``.

    The first n pixels of the renderer's film (the bench's is 512x512) in
    32x32-block order, as ``Renderer.render`` sends them; cosine bounces from
    the primary hits with the uniforms of ``fold_in(PRNGKey(seed), pixel
    id)``; shadow rays from the same origins toward light 0, stopping short
    of it.
    """
    dev = torch.device(r.device)
    cam = camera_params(r.camera, dev)
    ys, xs = np.mgrid[0 : r.height, 0 : r.width]
    xs, ys = xs.ravel(), ys.ravel()
    order = blocked_order(xs, ys, r.width)
    px = torch.as_tensor(xs[order][:n], device=dev)
    py = torch.as_tensor(ys[order][:n], device=dev)
    x = (px.to(torch.float32) + 0.5) / r.width
    y = (py.to(torch.float32) + 0.5) / r.height
    o, d = generate_rays(cam, x, y)
    o = o.contiguous()
    t_lo = cam.n_clip.expand(n).contiguous()
    t_hi = cam.f_clip.expand(n).contiguous()
    primary = (o, d, t_lo, t_hi)

    hit, _ = trace_closest(r.bundle, o, d, t_lo, t_hi)
    hit_p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]

    # incoherent bounce wavefront: cosine scatter from the hit points
    key = _rng.prng_key(seed, device=dev)
    keys = _rng.fold_in(key.expand(n, 2), (py.to(torch.int64) * r.width + px) & _rng.MASK32)
    u3 = _rng.uniform(keys, (3,))
    z = torch.sqrt(u3[:, 0])
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u3[:, 0], 0.0))
    phi = 2 * math.pi * u3[:, 1]
    wi = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), z], dim=-1)
    d2 = local_to_world(make_coord_space(hit.n), wi)
    o2 = hit_p + hit.n * 1e-4
    eps = torch.full((n,), 1e-4, device=dev)
    bounce = (o2, d2, eps, torch.where(hit.hit, 1e30, 0.0))

    # shadow wavefront toward the first light
    lp = torch.as_tensor(r.scene.lights.position[0], dtype=torch.float32, device=dev)
    wl = lp - hit_p
    dist = torch.linalg.norm(wl, dim=-1, keepdim=True)
    wl = wl / torch.clamp_min(dist, 1e-9)
    shadow = (o2, wl.contiguous(), eps, torch.where(hit.hit, dist[:, 0] * 0.999, 0.0))
    return primary, bounce, shadow


def random_rays(r: Renderer, n: int, gen: torch.Generator):
    """Camera, bounce and shadow rays of n random pixels of the renderer's film.

    Bounces leave the camera hits (misses dead), scattered about the normal;
    shadow rays go toward the sun on even lanes and along the bounce
    direction on odd ones (so that some are occluded), with about 30% dead
    lanes.  ``gen`` is a generator on the renderer's device.
    """
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
    sun = r.bundle.lights.direction[0].expand(n, 3)
    odd = (torch.arange(n, device=dev) % 2 == 1)[:, None]
    s_dir = torch.where(odd, w, sun).contiguous()
    live = hit.hit & (torch.rand(n, device=dev, generator=gen) > 0.3)
    shadow = (_offset_origin(p, nrm, s_dir), s_dir, eps, torch.where(live, 1e30, 0.0))
    return {"camera": cam_rays, "bounce": bounce, "shadow": shadow}


def _kernels_run(fn):
    """fn() and the keys of the kernels it launched ("" on the CPU, which launches none)."""
    before = {k: v.launches for k, v in ic.KERNELS.items()}
    out = fn()
    return out, "".join(k for k, v in ic.KERNELS.items() if v.launches > before[k])


def _emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def bench_default(rows, name, r, waves, n):
    cs = r.bundle.cscene
    for kind, rays, any_hit in zip(
        ("primary_closest", "bounce_closest", "shadow_anyhit"), waves, (False, False, True)
    ):
        def fn(rays=rays, any_hit=any_hit):
            return ic.intersect(cs, *rays, any_hit=any_hit)

        out, keys = _kernels_run(fn)
        ms = cuda_ms(fn)
        live = float((rays[3] > rays[2]).sum())
        _emit(rows, {
            "scene": name, "tris": int(r.scene.num_triangles), "wavefront": kind, "lanes": n,
            "ms": ms, "mrays_per_s": None if ms is None else n / ms / 1e3,
            # counting basis differs between the brute and tree kernels:
            # compare within one scene and wavefront only
            "tests_per_live_ray": float(out[5].sum(dtype=torch.float64)) / max(live, 1.0),
            "kernel": keys,
        })


def bench_group(rows, name, r, waves, cases):
    """Kernel F at top_batch 2 and 4 against the default walk (A, B); must match exactly."""
    cs = r.bundle.cscene
    _, bounce, shadow = waves
    for tb in (2, 4):
        row = {"scene": name, "check": f"top_batch{tb}_parity", "ok": True, "top_batch": tb}
        for kind, rays, any_hit in (("bounce", bounce, False), ("shadow", shadow, True)):
            def base(rays=rays, any_hit=any_hit):
                return ic.intersect(cs, *rays, any_hit=any_hit)

            def group(rays=rays, any_hit=any_hit, tb=tb):
                return ic.intersect(cs, *rays, any_hit=any_hit, top_batch=tb)

            want, base_keys = _kernels_run(base)
            got, group_keys = _kernels_run(group)
            assert group_keys in ("F", ""), f"top_batch={tb} ran {group_keys!r}, not kernel F"
            for j, field in ((0, "t"), (1, "prim"), (4, "hit")):
                if not torch.equal(got[j], want[j]):
                    raise AssertionError(f"{name}: top_batch={tb} group walk diverges on {field} ({kind})")
            row[f"{kind}_ms"] = cuda_ms(group)
            cases.append(Case("F", f"{name}_{kind}_tb{tb}", cs, rays, any_hit, tb, row[f"{kind}_ms"], want[5]))
            row[f"{kind}_{base_keys}_ms"] = cuda_ms(base)
            row[f"{kind}_tests"] = int(got[5].sum(dtype=torch.int64))
            row[f"{kind}_{base_keys}_tests"] = int(want[5].sum(dtype=torch.int64))
        _emit(rows, row)


def mxu_rays(scene, n: int, device):
    """ab_mxu_mt.py's camera rays over a sqrt(n)-square film and its random bounces."""
    cam = Camera()
    center = (scene.bbox_min + scene.bbox_max) / 2
    extent = float(np.linalg.norm(scene.bbox_max - scene.bbox_min))
    cam.place(center, np.pi / 3, np.pi / 4, extent, extent / 10, extent * 10)
    side = int(math.isqrt(n))
    n = side * side
    ys, xs = np.mgrid[0:side, 0:side]
    x = torch.as_tensor((xs.ravel() + 0.5) / side, dtype=torch.float32, device=device)
    y = torch.as_tensor((ys.ravel() + 0.5) / side, dtype=torch.float32, device=device)
    o, d = generate_rays(camera_params(cam, device), x, y)
    o = o.contiguous()
    t_lo = torch.full((n,), 1e-3, device=device)
    t_hi = torch.full((n,), 1e30, device=device)
    rng = np.random.default_rng(0)
    ob = o.cpu().numpy() + d.cpu().numpy() * rng.uniform(0.3, 0.9, (n, 1))
    db = rng.normal(size=(n, 3))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    ob, db = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (ob, db))
    return {"primary": (o, d, t_lo, t_hi), "bounce": (ob, db, t_lo, t_hi)}


def bench_mxu(rows, n, device, cases):
    """Kernel E (coefficient walk) against kernel A on the exact-fit trees."""
    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    for nq, shape in MXU_SCENES:
        scene = make_terrain_scene(nq)
        wb = build_wide_bvh(scene.tri_p, *shape)
        cs = ic.CudaScene.from_wide_bvh(wb, *none, scene.num_triangles, device, mxu=True)
        assert cs.mxu
        for kind, rays in mxu_rays(scene, n, device).items():
            def base(rays=rays):
                return ic.intersect(cs, *rays)

            def mxu(rays=rays):
                return ic.intersect(cs, *rays, mxu=True)

            rb, base_keys = _kernels_run(base)
            rm, mxu_keys = _kernels_run(mxu)
            assert mxu_keys in ("E", ""), f"mxu=True ran {mxu_keys!r}, not kernel E"
            base_ms, mxu_ms = cuda_ms(base), cuda_ms(mxu)
            cases.append(Case("E", f"terrain{nq}_{kind}", cs, rays, False, 1, mxu_ms, rb[5]))
            hb, hm = rb[4], rm[4]
            both = hb & hm
            t_b, t_m = rb[0][both], rm[0][both]
            _emit(rows, {
                "scene": f"terrain{nq}", "tree": "x".join(map(str, shape)), "wavefront": kind,
                "lanes": int(rays[0].shape[0]), "base_kernel": base_keys,
                "base_ms": base_ms, "mxu_ms": mxu_ms,
                "speedup": None if mxu_ms is None else base_ms / mxu_ms,
                "hit_agree": float((hb == hm).double().mean()),
                "prim_agree": float((rb[1][both] == rm[1][both]).double().mean()) if both.any() else 1.0,
                "t_maxrel": float(((t_b - t_m).abs() / torch.clamp_min(t_b.abs(), 1e-6)).max()) if both.any() else 0.0,
                "tests_base": int(rb[5].sum(dtype=torch.int64)), "tests_mxu": int(rm[5].sum(dtype=torch.int64)),
            })


def vertex_bytes(n: int, n_slots: int, vertex: int, bounce: bool, last: bool, g_walk: bool = False,
                 general: bool = False, area_slots: int = 0):
    """(I-a bytes, I-b bytes) that kernel I loads and stores for one ``n``-lane vertex, each counted once.

    I-a reads the walk (t, id, the slot map's entry or kernel G's found
    byte, barycentrics, tests: 24 bytes, 21 from G; the 40-byte shading
    row), the ray (base, direction, t_hi: 28), the three uniforms of the
    roulette and the cosine sample when a bounce follows (12) and, past the
    camera vertex, its state (64) (the bench's lanes carry no ``valid``
    mask); it writes its state (64), per slot a shadow ray and a
    contribution (44) and, when a bounce follows, the bounce ray and the
    point (44).  I-b reads per slot the occluder word (a byte from G), the
    tests and the contribution (20, 17 from G), the lane's flags and tests
    (8) and the radiance it adds to: L0 at the camera vertex (12), past it L
    and the throughput (24), and L0 too after the last vertex (12); it
    writes that radiance and the tests (16) and, after the last vertex, the
    sample's radiance (12).  I-a's ``general`` instance reads besides, past
    the camera vertex, the walked ray's origin (12; the camera's is the base
    point), glass's coin (4) when a bounce follows, and each of the
    ``area_slots`` slots' two uniforms (8).  The material, light and sphere
    rows are a few, read through L1, and not counted.
    """
    extra = ((12 if vertex else 0) + (4 if bounce else 0) + 8 * area_slots) if general else 0
    ia = n * (24 - (3 if g_walk else 0) + 40 + 28 + (12 if bounce else 0) + (64 if vertex else 0)
              + 64 + 44 * n_slots + (44 if bounce else 0) + extra)
    ib = n * ((20 - (3 if g_walk else 0)) * n_slots + 8 + (24 if vertex else 12) + 16
              + ((12 + (12 if vertex else 0)) if last else 0))
    return ia, ib


VERTEX_CELLS = {
    # the cells' wavefronts: the first 65,536 lanes of a 1080p film in 32x32-block order (the orbit's
    # terrain 512, pinhole; config 2's terrain 256, thin lens and octagon bokeh), of the viewer's
    # 800x600 film row by row (terrain 512), and the Cornell cell's whole 256x256 film in block order
    # (scene/writer.py:cornell_box: its four light slots, sphere hits, every family but refraction)
    "terrain_orbit_1080p": (512, 1920, 1080, False, True),
    "config2_adaptive_1080p": (256, 1920, 1080, True, True),
    "terrain_viewer_800x600": (512, 800, 600, False, False),
    "cornell_256_16spp": ("cornell", 256, 256, False, True),
}


def vertex_wavefront(r, n: int, blocked: bool, seed: int = 2_147_483_659):
    """(tape, camera rays) of sample 0 of the first ``n`` pixels of ``r``'s film, in 32x32-block order or
    row by row, as ``integrator.path.radiance_sample`` makes them."""
    from .integrator import path as P
    from .scene.camera import generate_rays_bokeh

    b, s, dev, w, h = r.bundle, r.settings, torch.device(r.device), r.width, r.height
    ys, xs = np.mgrid[0:h, 0:w]
    xs, ys = xs.ravel(), ys.ravel()
    order = blocked_order(xs, ys, w) if blocked else np.arange(w * h)
    px, py = (torch.as_tensor(a[order][:n], device=dev) for a in (xs, ys))
    keys = _rng.fold_in(P.pixel_keys(_rng.prng_key(seed, device=dev), px, py, w), 0)
    tape = _rng.uniform(keys, (P.tape_size(s),))
    cam = camera_params(r.camera, dev)
    x, y = (px.to(torch.float32) + tape[:, 0]) / w, (py.to(torch.float32) + tape[:, 1]) / h
    if s.use_thin_lens and b.bokeh is not None:
        o, d = generate_rays_bokeh(cam, x, y, b.bokeh.sample(tape[:, 2], jitter=tape[:, 3]))
    else:
        o, d = generate_rays(cam, x, y)
    m = px.shape[0]
    return tape, (o.contiguous(), d.contiguous(), cam.n_clip.expand(m).contiguous(), cam.f_clip.expand(m).contiguous())


def _max_err(got, want, mask=None) -> float:
    """The largest absolute difference of two tensors of one shape (0.0: equal; NaN matches NaN, and
    against a number counts as inf), over the lanes of ``mask`` if one is given."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} and {tuple(want.shape)}")
    got, want = got.double(), want.double()
    if mask is not None:
        got, want = got[mask], want[mask]
    same = (got == want) | (got.isnan() & want.isnan())
    return 0.0 if bool(same.all()) else float((got - want)[~same].abs().nan_to_num(math.inf).max())


def vertex_errors(b, s, tape, ray, valid=None) -> dict:
    """Kernel I against the plain vertex functions on vertices 0 and 1 of one wavefront: each output's
    largest absolute difference, by name (``v0.shadow_o``, ``v1.L``, ...).

    Both routes walk their own rays.  After I-a (``_shade_kernel`` against
    ``_shade_plain``): the shadow rays (origin, direction, t_lo, t_hi) and
    the contributions they gate; the bounce ray and the vertex point; the
    state (L0, L, the throughput, the flags alive, bounce and camera hit) and
    the throughput step the next vertex takes, on the lanes whose bounce is
    traced.  After I-b (``_gather_kernel`` against ``_gather_plain``): L0,
    L and the stats [rays, tests, skipped], the lanes' counts summed.
    """
    from .integrator import path as P

    n_vertices = s.max_ray_depth if s.indirect and s.max_ray_depth > 1 else 1
    if n_vertices < 2:
        raise ValueError("vertex_errors needs paths of two vertices or more")
    errs = {}
    kpath = ppath = None
    kray = pray = ray
    for k in (0, 1):
        def put(name, got, want, mask=None, k=k):
            errs[f"v{k}.{name}"] = _max_err(got, want, mask)

        kpath, knee, kray = P._shade_kernel(b, s, tape, k, n_vertices, P._walk_closest(b, *kray, coherent=k == 0),
                                            kray, kpath, valid)
        ppath, pnee, pray = P._shade_plain(b, s, tape, k, n_vertices, P.trace_closest(b, *pray, coherent=k == 0),
                                           pray, ppath, valid)
        flags = kpath.istate[:, 3]
        put("L0", kpath.fstate[:, 0:3], ppath.L0)
        put("L", kpath.fstate[:, 3:6], ppath.L)
        put("throughput", kpath.fstate[:, 6:9], ppath.throughput)
        put("alive", flags & 1 != 0, ppath.alive)
        put("camera_hit", flags & 4 != 0, ppath.hit0)
        if pnee is not None:
            for name, got, want in zip(("o", "d", "t_lo", "t_hi"), knee, pnee.rays):
                put(f"shadow_{name}", got, want)
            put("contrib", kpath.contrib, pnee.value)
        if pray is not None:
            for name, got, want in zip(("o", "d", "t_lo", "t_hi"), kray, pray):
                put(f"bounce_{name}", got, want)
            put("point", kpath.pb, ppath.p)
            put("bounce", flags & 2 != 0, ppath.bounce)
            bs = ppath.bs
            cos = torch.abs(bs.wi[:, 2]) / torch.clamp_min(P.norm3(bs.wi), 1e-30)
            put("step", kpath.fstate[:, 9:12], bs.f * (cos / (bs.pdf * P.CPDF))[:, None], ppath.bounce)
        kpath = P._gather_kernel(s, k, kpath, knee, P._walk_any(b, *knee) if knee else None, n_vertices)
        ppath = P._gather_plain(b, s, k, ppath, pnee, P._nee_walk(b, s, pnee) if pnee else None)
        put("L0_gathered", kpath.fstate[:, 0:3], ppath.L0)
        put("L_gathered", kpath.fstate[:, 3:6], ppath.L)
        put("stats", kpath.istate[:, :3].sum(dim=0, dtype=torch.float64),
            ppath.stats + ppath.stats_ind if k else ppath.stats)
    return errs


def bench_vertex(rows, device, n: int = 65_536):
    """Kernel I on a 65,536-lane camera vertex (0) and first bounce vertex (1) of each ``VERTEX_CELLS`` cell.

    ``ia_ms``, ``ib_ms``: each launch alone (:func:`cuda_ms`);
    ``ia_general_ms``: I-a with its general instance forced, on the cells that
    run the diffuse one (else None); ``bound_ms``:
    :func:`vertex_bytes` at 3.35 TB/s; ``plain_ms``: the device time of the
    plain vertex functions' kernels for the camera vertex (a profiled call of
    the walk, ``_shade_plain``, the shadow walk and ``_gather_plain``, the
    walks' own kernels left out); ``registers``: ``ptxas`` of this
    process's build (empty when an earlier process built the library);
    ``max_abs_err``: the largest of :func:`vertex_errors` on that vertex,
    every output of I-a and I-b against the plain functions', and
    ``worst``: its output.  Raises unless every one is 0.0: bit for bit.
    """
    import tempfile
    from unittest import mock

    from . import compiled
    from .ab_walk import call_profile, config2_renderer
    from .integrator import path as P
    from .ops import _build
    from .scene.build import LT_AREA
    from .scene.writer import cornell_box

    _build.load_library()
    regs = {k: v for k, v in _build.ptxas_report(_build.build_log).items() if "vertex" in k}
    for cell, (nq, w, h, bokeh, blocked) in VERTEX_CELLS.items():
        if nq == "cornell":
            r = Renderer(width=w, height=h, ns_aa=16, max_ray_depth=5, indirect=True, device=str(device))
            with tempfile.TemporaryDirectory() as tmp:
                r.load(cornell_box().write(Path(tmp) / "cornell.dae"))
        elif bokeh:
            r, _ = config2_renderer(nq, str(device), width=w, height=h, ns_aa=16, samples_per_batch=4)
        else:
            r = Renderer(width=w, height=h, ns_aa=1, max_ray_depth=4, indirect=True, device=str(device))
            r.load_flat_scene(make_terrain_scene(nq))
        b, s = r.bundle, r.settings
        tape, ray = vertex_wavefront(r, n, blocked)
        depth = s.max_ray_depth
        slots = len(s.light_slots)
        general = P._general_vertex_kernel(b, s)
        area_slots = sum(code == LT_AREA for code in s.light_slot_types)
        with compiled.disabled():
            errs = vertex_errors(b, s, tape, ray)
            walk0 = P._walk_closest(b, *ray, coherent=True)
            kpath, nee, bray = P._shade_kernel(b, s, tape, 0, depth, walk0, ray, None, None)
            occ0 = P._walk_any(b, *nee)
            P._gather_kernel(s, 0, kpath, nee, occ0, depth)
            walk1 = P._walk_closest(b, *bray)
            vertices = {
                0: (lambda: P._shade_kernel(b, s, tape, 0, depth, walk0, ray, None, None),
                    lambda: P._gather_kernel(s, 0, kpath, nee, occ0, depth)),
                1: (lambda: P._shade_kernel(b, s, tape, 1, depth, walk1, bray, kpath, None),
                    lambda: P._gather_kernel(s, 1, kpath, nee, occ0, depth)),
            }

            def plain0():
                walked = P.trace_closest(b, *ray, coherent=True)
                pp, pn, _ = P._shade_plain(b, s, tape, 0, depth, walked, ray, None, None)
                return P._gather_plain(b, s, 0, pp, pn, P._nee_walk(b, s, pn))

            def general_ms(ia):
                """I-a's time on these lanes with its general instance forced in place of the diffuse one."""
                with mock.patch.object(P, "_general_vertex_kernel", lambda *_: True):
                    return cuda_ms(lambda: ia()[0])

            plain_kernels = call_profile(plain0)
            plain_ms = sum(v for k, v in plain_kernels.items()
                           if not k.split("<")[0].endswith(("walk_kernel", "brute_kernel")))
            for k, (ia, ib) in vertices.items():
                ia_b, ib_b = vertex_bytes(n, slots, k, k < depth - 1, k == depth - 1, b.cscene is None, general,
                                          area_slots)
                mine = {name: e for name, e in errs.items() if name.startswith(f"v{k}.")}
                worst = max(mine, key=mine.get)
                row = {
                    "kernel": "I", "cell": cell, "vertex": k, "lanes": n, "slots": slots,
                    "instance": "general" if general else "diffuse",
                    "ia_ms": cuda_ms(lambda ia=ia: ia()[0]), "ib_ms": cuda_ms(lambda ib=ib: (ib().fstate,)),
                    "ia_general_ms": general_ms(ia) if not general else None,
                    "bound_ms": (ia_b + ib_b) / PEAK_BYTES * 1e3, "bound_by": "bytes", "bytes": ia_b + ib_b,
                    "plain_ms": plain_ms if k == 0 else None, "registers": regs,
                    "max_abs_err": mine[worst], "worst": worst if mine[worst] else None, "outputs_compared": len(mine),
                }
                _emit(rows, row)
        wrong = {name: e for name, e in errs.items() if e != 0.0}
        if wrong:
            raise AssertionError(f"{cell}: kernel I differs from the plain vertex functions: {wrong}")


def main(argv=None, cases: list | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262144, help="lanes per wavefront")
    ap.add_argument("--scenes", default="8,256,512", help="terrain n_quads for the default and group walks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="JSON artifact path")
    args = ap.parse_args(argv)
    if args.n > FILM * FILM:
        raise ValueError(f"--n is at most {FILM * FILM} (the 512x512 film)")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench measures the kernels on a card (--device cpu "
                               "runs the plain versions without timing)")
        device_name, smi = torch.cuda.get_device_name(0), nvidia_smi()
    else:
        device_name, smi = "cpu", ""
    device = torch.device(args.device)
    cases = [] if cases is None else cases

    rows = []
    for nq in (int(s) for s in args.scenes.split(",") if s):
        r = build_renderer(nq, device)
        name = f"terrain{nq}"
        waves = wavefronts(r, args.n)
        bench_default(rows, name, r, waves, args.n)
        cs = r.bundle.cscene
        if cs.b1 > 1 and not cs.stream:
            bench_group(rows, name, r, waves, cases)
    bench_mxu(rows, args.n, device, cases)
    if args.device == "cuda":
        bench_vertex(rows, device)

    artifact = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device": device_name, "nvidia_smi": smi, "torch": torch.__version__,
        "lanes": args.n, "rows": rows,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(f"# wrote {out}", flush=True)
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
