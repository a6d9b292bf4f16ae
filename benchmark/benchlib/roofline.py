"""The trace kernels' share of their roofline, on a cell's own scene and wavefronts.

Frozen from ``lens_flare_tpu_torch/bench_kernels.py`` (``cuda_ms``,
``chunk_pairs``, ``chunks_hit``, ``bound``, the published peaks and the
bytes per record) and ``ops/intersect_cuda.py`` (``_safe_inv``,
``_box_hits``), with one correction: the operations are the slot tests
the function needs, ``k`` per (ray, chunk) pair that a closest-hit ray
enters before its hit or an unoccluded shadow ray enters at all, and ``k``
for each occluded shadow ray (the chunk that holds its occluder), not the
kernel's own ``tests`` counter, so a walk that tests more, or fewer,
does not move its own bound.  Bytes are counted by need, as before.

The bound is max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), NVIDIA's published
float32 (no tensor cores) and HBM3 peaks of the H100 SXM at its 700 W limit;
the harness prints the card's own power limit beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOP_PER_TEST = {"closest": 46, "any": 48}
LANE_BYTES = 32 + 20  # o, d, t_lo, t_hi in; t, slot, bary, tests out
BOX_BYTES = 24
TRI_ROW_BYTES = 36
SHADE_ROW_BYTES = 40
KINF = 3.0e38
QUEUE_CYCLES = 50_000_000  # ~0.03 s of device sleep ahead of the timed calls
REPEATS = 5


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Mean device ms of fn() over ``repeats`` calls after one warm-up, queued behind a device sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def safe_inv(d):
    eps = 1e-12
    return 1.0 / torch.where(d >= 0, torch.clamp_min(d, eps), torch.clamp_max(d, -eps))


def box_hits(boxes, o, inv, t_lo, t_hi):
    """Slab tests of rays (N,) against boxes (B, 8) -> (N, B) bool."""
    bx = boxes[None]
    t_min = t_max = None
    for a in range(3):
        t1 = (bx[..., a] - o[:, a, None]) * inv[:, a, None]
        t2 = (bx[..., 3 + a] - o[:, a, None]) * inv[:, a, None]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_min = torch.clamp_min(lo, -KINF) if t_min is None else torch.maximum(t_min, lo)
        t_max = torch.clamp_max(hi, KINF) if t_max is None else torch.minimum(t_max, hi)
    t_lo, t_hi = t_lo[:, None], t_hi[:, None]
    return (t_min <= t_max) & (t_max >= t_lo) & (t_min <= t_hi) & (t_lo <= t_hi)


def chunk_pairs(tree, o, d, t_lo, t_hi):
    """Per top a ray enters within [t_lo, t_hi]: (top, lanes, chunks) of the (lane, chunk) pairs entered."""
    inv = safe_inv(d)
    if tree.b1 > 1:
        top_hits = box_hits(tree.top, o, inv, t_lo, t_hi)
        tops = top_hits.any(dim=0).nonzero()[:, 0].tolist()
    else:
        top_hits, tops = None, [0]
    child = tree.child.view(tree.b1, tree.b2, 8)
    for tp in tops:
        lanes = top_hits[:, tp].nonzero()[:, 0] if top_hits is not None else torch.arange(o.shape[0], device=o.device)
        ch = box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_hi[lanes])
        pl, pc = ch.nonzero(as_tuple=True)
        yield tp, lanes[pl], pc


def work(tree, kind: str, rays, out) -> dict:
    """The operations and bytes a trace call needs: ``out`` = (t, slot, ...) of the call, its
    fifth entry the shading rows of kernel D.  The call's own ``tests`` are not read."""
    o, d, t_lo, t_hi = rays
    t, slot = out[0], out[1]
    n = o.shape[0]
    shade = len(out) > 4
    if kind == "any":
        live, clip = slot < 0, t_hi
    else:
        live, clip = torch.ones_like(slot, dtype=torch.bool), torch.minimum(t_hi, t)
    pairs = n_tops = n_chunks = 0
    for _, lanes, pc in chunk_pairs(tree, o[live], d[live], t_lo[live], clip[live]):
        pairs += int(lanes.numel())
        n_tops += 1
        n_chunks += int(torch.unique(pc).numel())
    tests = tree.k * pairs
    if kind == "any":
        tests += tree.k * int((~live & (t_hi > t_lo)).sum())
    nbytes = n * (LANE_BYTES + (SHADE_ROW_BYTES if shade else 0))
    nbytes += BOX_BYTES * tree.b1 + BOX_BYTES * tree.b2 * n_tops + TRI_ROW_BYTES * tree.k * n_chunks
    if shade:
        tri_slot = slot[(slot >= 0) & (slot < tree.b1 * tree.b2 * tree.k)]
        nbytes += SHADE_ROW_BYTES * int(torch.unique(tri_slot).numel())
    return {"flops": float(tests) * FLOP_PER_TEST[kind], "bytes": float(nbytes)}


def bound_ms(w: dict) -> tuple[float, str]:
    t_ops, t_bytes = w["flops"] / PEAK_FLOPS, w["bytes"] / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _blocked(width: int, height: int, n: int):
    """The first n pixels of the film in 32x32-block order, as the renderer sends them."""
    ys, xs = np.mgrid[0:height, 0:width]
    xs, ys = xs.ravel(), ys.ravel()
    order = np.argsort(((ys // 32) * ((width + 31) // 32) + (xs // 32)) * 1024 + (ys % 32) * 32 + (xs % 32),
                       kind="stable")
    return xs[order][:n], ys[order][:n]


def wavefronts(trace, cam: dict, tri_rows, width: int, height: int, lanes: int, light_pos, seed: int):
    """(camera, bounce, shadow) rays of the cell's film, each of ``lanes`` lanes in blocked order.

    ``trace(o, d, t_lo, t_hi)`` -> (t, slot, ...) is the program's closest-hit call;
    ``tri_rows(slot)`` the (N, 9) [p0 | e1 | e2] rows of the slots hit.  Camera
    rays through the pixel centres; cosine bounces about the geometric normal
    with the uniforms of ``fold_in(PRNGKey(seed), pixel id)``; shadow rays from
    the same points to the point light, stopping short of it.
    """
    dev = cam["pos"].device
    xs, ys = _blocked(width, height, lanes)
    px = torch.as_tensor(xs, device=dev)
    py = torch.as_tensor(ys, device=dev)
    x = (px.to(torch.float32) + 0.5) / width
    y = (py.to(torch.float32) + 0.5) / height
    cx = cam["tan_half_h"] * (2.0 * x - 1.0)
    cy = cam["tan_half_v"] * (2.0 * y - 1.0)
    d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d = d_cam @ cam["c2w"].T
    o = cam["pos"].expand(d.shape).contiguous()
    n = o.shape[0]
    t_lo = cam["n_clip"].expand(n).contiguous()
    t_hi = cam["f_clip"].expand(n).contiguous()
    primary = (o, d.contiguous(), t_lo, t_hi)

    out = trace(*primary)
    t, slot = out[0], out[1]
    hit = slot >= 0
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    rows = tri_rows(torch.clamp_min(slot, 0).long())
    nrm = torch.cross(rows[:, 3:6], rows[:, 6:9], dim=-1)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True), 1e-30)
    nrm = torch.where(((nrm * d).sum(-1) > 0)[:, None], -nrm, nrm)
    keys = rng.fold_in(rng.prng_key(seed, dev).expand(n, 2), (py.to(torch.int64) * width + px) & rng.MASK32)
    u = rng.uniform(keys, (2,))
    r = torch.sqrt(u[:, 0])
    phi = 2 * math.pi * u[:, 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp_min(1 - u[:, 0], 0.0))], -1)
    helper = torch.where(torch.abs(nrm[:, 0:1]) > 0.9, torch.tensor([0.0, 1.0, 0.0], device=dev),
                         torch.tensor([1.0, 0.0, 0.0], device=dev))
    tx = torch.cross(helper, nrm, dim=-1)
    tx = tx / torch.clamp_min(torch.linalg.norm(tx, dim=-1, keepdim=True), 1e-30)
    ty = torch.cross(nrm, tx, dim=-1)
    d2 = local[:, 0:1] * tx + local[:, 1:2] * ty + local[:, 2:3] * nrm
    o2 = (p + nrm * 1e-4).contiguous()
    eps = torch.full((n,), 1e-4, device=dev)
    bounce = (o2, d2.contiguous(), eps, torch.where(hit, 1e30, 0.0).contiguous())
    wl = torch.as_tensor(light_pos, dtype=torch.float32, device=dev) - p
    dist = torch.linalg.norm(wl, dim=-1, keepdim=True)
    shadow = (o2, (wl / torch.clamp_min(dist, 1e-9)).contiguous(), eps,
              torch.where(hit, dist[:, 0] * 0.999, 0.0).contiguous())
    return {"camera": primary, "bounce": bounce, "shadow": shadow}
