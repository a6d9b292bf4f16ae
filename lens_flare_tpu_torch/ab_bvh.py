"""A/B of kernel G between a version of ``ops/csrc/intersect.cu`` from before its packed layout and this checkout's.

    python -m lens_flare_tpu_torch.ab_bvh --baseline DIR [--out PATH]

``DIR`` holds an ``intersect.cu`` whose ``lf_bvh_walk`` reads the
``FlatBVH``'s own arrays (commit cc6852e and older, one ray per thread):
node boxes (M, 8), links (M, 4), ``prim_order`` (P,), triangle rows (T, 12)
in scene order and sphere rows (S, 8).  Both libraries are built with
``ops/_build.py``'s flags and loaded into one process.  The baseline's
arrays are made once per scene from the packed ones
(``ops/intersect.py:unpack_bvh``), before any timed call, and its launches
go through :func:`legacy_walk`; the checkout's through
``intersect_cuda.bvh_walk``.  While the baseline is current, the renderer's
walk (``integrator/path.py``'s ``bvh_walk``) takes :func:`legacy_walk` too.

Scenes: terrain 512 (524,288 triangles) under ``Renderer(use_wide_tree=False)``
and the 16,785,218-triangle terrain past the cluster tree's capacity
(``chip_smoke.py`` phase 11's renderer: 1920x1080, 1 spp, depth 1).  Rows,
65,536 lanes each: random pixels of the film (``bench_kernels.random_rays``)
and the renderer's first pixels in 32x32-block order
(``bench_kernels.wavefronts``), camera rays (closest hit) and shadow rays
(any hit).  Before the steps: each row's plain-version ms, bound
(``bench_kernels.bvh_bound``) and visits.  The steps alternate, baseline,
checkout, checkout, baseline (``ORDER``); each measures every row's device
ms (``bench_kernels.cuda_ms``, ``REPEATS`` calls after a warm-up) and host
ms per call, and the ``past_capacity`` frame under
``ab_walk.frame_profile`` (``frame_s``, G's kernel ms, launches, the
device's busy share).  Every step's row outputs and frame must equal the
first step's bit for bit.  It prints one JSON line per step and writes
them all, with the card's ``nvidia-smi`` line, to ``--out`` (default
``_build/ab_bvh.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import bench_kernels as bk
from .ab_walk import frame_profile
from .integrator import path
from .ops import _build
from .ops import intersect_cuda as ic
from .ops.intersect import unpack_bvh
from .renderer import Renderer
from .scene.procedural import make_terrain_scene

LANES = 1 << 16  # the main path's wavefront (Renderer.tile_pixels)
REPEATS = 20
ORDER = "BCCB"  # B the baseline, C this checkout
DEFAULT_OUT = Path(__file__).resolve().parent / "_build" / "ab_bvh.json"
PAST_CAPACITY_QUADS = 2897  # 2 * 2897^2 = 16,785,218 triangles
# lf_bvh_walk's argtypes before the packed layout: rays, boxes, links,
# prim_order, tri, sph; n, num_tris, any_hit; six outputs and the stream
LEGACY_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7


class Legacy(NamedTuple):
    """A FlatBVH and its rows as the walk before the packing read them."""

    node_box: torch.Tensor  # (M, 8) [min.xyz | max.xyz | pad]
    node_link: torch.Tensor  # (M, 4) int32 [left, right, start, count]
    prim_order: torch.Tensor  # (max(P, 1),) int32
    tri: torch.Tensor  # (max(T, 1), 12) [p0 | e1 | e2 | pad], scene order
    sph: torch.Tensor  # (max(S, 1), 8) [center | radius | pad]


def legacy_arrays(bv: ic.BvhArrays) -> Legacy:
    """The baseline's arrays for the tree and primitives packed in ``bv``, on its device."""
    bvh, tri, sph = unpack_bvh(bv)
    box = np.zeros((bvh.num_nodes, 8), np.float32)
    box[:, 0:3], box[:, 3:6] = bvh.node_min, bvh.node_max
    link = np.stack([bvh.node_left, bvh.node_right, bvh.node_start, bvh.node_count], axis=1).astype(np.int32)

    def t(a, width):  # at least one row, as that version's bvh_to_device made them
        out = np.zeros((max(len(a), 1), width), a.dtype)
        out[: len(a)] = a.reshape(len(a), width)
        return torch.as_tensor(out, device=bv.rows.device)

    return Legacy(node_box=t(box, 8), node_link=t(link, 4), prim_order=t(bvh.prim_order, 1).view(-1),
                  tri=t(tri, 12), sph=t(sph, 8))


def legacy_walk(lib, leg: Legacy, bv: ic.BvhArrays, o, d, t_lo, t_hi, any_hit: bool = False):
    """One launch of the baseline's ``lf_bvh_walk`` on ``leg``; the outputs of ``intersect_cuda.bvh_walk``."""
    n = o.shape[0]
    dev = o.device
    o, d, t_lo, t_hi = (x.contiguous() for x in (o, d, t_lo, t_hi))
    out = (torch.empty(n, dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev), torch.empty(n, dtype=torch.int32, device=dev))
    rc = lib.lf_bvh_walk(
        o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), leg.node_box.data_ptr(),
        leg.node_link.data_ptr(), leg.prim_order.data_ptr(), leg.tri.data_ptr(), leg.sph.data_ptr(),
        n, bv.num_tris, int(any_hit), *(x.data_ptr() for x in out), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"baseline lf_bvh_walk failed to launch: cudaError {rc}")
    ic.KERNELS["G"].launches += 1
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="directory holding the baseline intersect.cu")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B measures kernels on a card")
    libs, ptxas = {}, {}
    for tag, build in (("B", lambda: _build.build(Path(args.baseline))), ("C", _build.build)):
        _build.build_log = ""
        libs[tag] = _build.open_library(build())
        ptxas[tag] = {k: v for k, v in _build.ptxas_report(_build.build_log).items() if k.startswith("bvh")}
    libs["B"].lf_bvh_walk.argtypes = LEGACY_SIGNATURE
    _build._lib = libs["C"]
    device = torch.device("cuda")

    # the scenes, their baseline arrays and the rows, all made before any timed call
    scenes, legacy, rows = {}, {}, []
    gen = torch.Generator(device=device)
    for nq in (512, PAST_CAPACITY_QUADS):
        kw = dict(ns_aa=1, max_ray_depth=1, seed=0) if nq == PAST_CAPACITY_QUADS else dict(max_ray_depth=4)
        r = Renderer(width=1920, height=1080, device="cuda", use_wide_tree=False, **kw)
        t0 = time.perf_counter()
        r.load_flat_scene(make_terrain_scene(nq))
        load_s = time.perf_counter() - t0
        bv = r.bundle.bvh
        t0 = time.perf_counter()
        leg = legacy[id(bv)] = legacy_arrays(bv)
        torch.cuda.synchronize()
        scenes[nq] = {
            "renderer": r, "tris": r.scene.num_triangles, "load_s": load_s,
            "bvh_build_s": r.stats.bvh_build_time, "bvh_pack_s": r.stats.bvh_pack_time,
            "legacy_arrays_s": time.perf_counter() - t0, "nodes": bv.num_nodes, "records": bv.nodes.shape[0],
            "depth": bv.max_depth,
            "packed_mib": sum(x.numel() * x.element_size() for x in (bv.root, bv.nodes, bv.rows)) / 2**20,
            "legacy_mib": sum(x.numel() * x.element_size() for x in leg) / 2**20,
        }
        gen.manual_seed(1 if nq == 512 else 2)  # chip_smoke.py phases 10 and 11
        rnd = bk.random_rays(r, LANES, gen)
        camera, _, shadow = bk.wavefronts(r, LANES)
        for kind, rays, any_hit in (("camera_random", rnd["camera"], False), ("shadow_random", rnd["shadow"], True),
                                    ("camera_blocked", camera, False), ("shadow_blocked", shadow, True)):
            rows.append((f"t{nq}_{kind}", bv, rays, any_hit))

    def walk(bv, o, d, t_lo, t_hi, any_hit=False):
        if _build._lib is libs["B"]:
            return legacy_walk(libs["B"], legacy[id(bv)], bv, o, d, t_lo, t_hi, any_hit)
        return ic.bvh_walk(bv, o, d, t_lo, t_hi, any_hit)

    plain, bounds = {}, {}
    for label, bv, rays, any_hit in rows:
        visits = {}
        out = ic.bvh_walk_plain(bv, *rays, any_hit=any_hit, visits=visits)
        bounds[label] = bk.bvh_bound(bv, rays, out, visits)
        plain[label] = bk.cuda_ms(lambda: ic.bvh_walk_plain(bv, *rays, any_hit=any_hit), 1)
    smi = bk.nvidia_smi()
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas,
            "scenes": {nq: {k: v for k, v in sc.items() if k != "renderer"} for nq, sc in scenes.items()},
            "plain_ms": plain, "bounds": bounds}
    print(json.dumps(head), flush=True)

    rp = scenes[PAST_CAPACITY_QUADS]["renderer"]
    routed = path.bvh_walk
    path.bvh_walk = walk
    first, steps = {}, []
    try:
        for tag in ORDER:
            _build._lib = libs[tag]
            step = {"step": tag}
            for label, bv, rays, any_hit in rows:
                got = walk(bv, *rays, any_hit=any_hit)
                torch.cuda.synchronize()
                if label in first:
                    assert all(torch.equal(x, y) for x, y in zip(got, first[label])), f"{tag}: {label} differs"
                else:
                    first[label] = got
                step[label] = bk.cuda_ms(lambda: walk(bv, *rays, any_hit=any_hit), REPEATS)
                t0 = time.perf_counter()
                for _ in range(REPEATS):
                    walk(bv, *rays, any_hit=any_hit)
                step[f"{label}_host"] = (time.perf_counter() - t0) * 1e3 / REPEATS
                torch.cuda.synchronize()
            hdr, _ = rp.render(progress=False)
            torch.cuda.synchronize()
            if "frame" in first:
                assert torch.equal(hdr, first["frame"]), f"{tag}: the past_capacity frame differs"
            else:
                first["frame"] = hdr
            step["past_capacity"] = frame_profile(lambda: rp.render(progress=False))
            step["past_capacity"].update(rays=rp.stats.total_rays, isects_per_ray=rp.stats.isects_per_ray)
            steps.append(step)
            print(json.dumps(step), flush=True)
    finally:
        path.bvh_walk = routed
        _build._lib = libs["C"]
    artifact = {**head, "lanes": LANES, "repeats": REPEATS, "steps": steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
