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
  bounces: base_ms, mxu_ms, speedup, hit_agree, prim_agree and t_maxrel.

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
