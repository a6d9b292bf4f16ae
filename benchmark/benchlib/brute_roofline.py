"""The trace kernels' share of their roofline on a brute-mode scene (at most 512 triangles): kernels A and C.

``program.trace_roofline`` reads none on such a scene; this module times
the two kernels that scene's frames launch, each alone with CUDA events
(``roofline.cuda_ms``), on the cell's own wavefronts (:func:`wavefronts`):

- A, closest hit on the single-level cluster tree, on the camera
  wavefront and one bounce wavefront; its bound is ``roofline.work``'s
  (the slot tests of the chunks each ray enters, the bytes by need), which
  leaves out the sphere pass, so it is a lower bound;
- C, any hit by brute force, on one shadow wavefront per light of the
  scene, from the camera wavefront's hit points; its bound
  (:func:`brute_work`): every live lane tests every real triangle row and
  every sphere; bytes are the rays in and the results out, and the rows
  each block of ``BRUTE_LANES`` lanes stages (``ops/csrc/intersect.cu``).

The share is the sum of the bounds over the sum of the times.
"""

from __future__ import annotations

import math

import torch

from . import rng, roofline
from .scene import LT_DIRECTIONAL

BRUTE_LANES = 256  # lanes per block of kernel C; each block stages the scene's rows once
ROW_BYTES = 48  # a triangle row of kernel C: [p0 | e1 | e2 | pad], three float4
SPHERE_BYTES = 32  # a sphere row: [centre | radius | pad], two float4
# the sphere quadratic of ops/intersect_cuda.py:_sphere_pass: 33 additions, multiplications and divisions
# and a square root
SPHERE_FLOP_PER_TEST = 34
SHADOW_NAMES = {1: "directional", 2: "point", 3: "area", 5: "spot"}


def brute_work(s_real: int, n_spheres: int, rays) -> dict:
    """Kernel C's operations and bytes on ``rays`` (o, d, t_lo, t_hi): each lane with t_hi > t_lo tests
    the ``s_real`` triangle rows and the ``n_spheres`` spheres."""
    n = rays[0].shape[0]
    live = int((rays[3] > rays[2]).sum())
    flops = live * (s_real * roofline.FLOP_PER_TEST["any"] + n_spheres * SPHERE_FLOP_PER_TEST)
    blocks = -(-n // BRUTE_LANES)
    nbytes = n * roofline.LANE_BYTES + blocks * (s_real * ROW_BYTES + n_spheres * SPHERE_BYTES)
    return {"flops": float(flops), "bytes": float(nbytes)}


def wavefronts(closest, cs, cam: dict, width: int, height: int, lanes: int, lights: dict, seed: int) -> dict:
    """The cell's rays, each wavefront of ``lanes`` lanes in blocked order: ``camera`` (pixel centres),
    ``bounce`` (cosine about each hit's geometric normal, uniforms of ``fold_in(PRNGKey(seed), pixel id)``)
    and ``shadow_<kind>`` per light of ``lights`` (``type``, ``position``, ``direction`` rows): from the
    camera hits toward the light's position, stopping short, or along a directional light's direction.
    ``closest(o, d, t_lo, t_hi)`` is the program's closest-hit call; a slot at or past the tree's
    triangle slots is a sphere of ``cs.sph``."""
    dev = cam["pos"].device
    xs, ys = roofline._blocked(width, height, lanes)
    px, py = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    cx = cam["tan_half_h"] * (2.0 * (px.to(torch.float32) + 0.5) / width - 1.0)
    cy = cam["tan_half_v"] * (2.0 * (py.to(torch.float32) + 0.5) / height - 1.0)
    d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
    d = (d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)) @ cam["c2w"].T
    n = d.shape[0]
    o = cam["pos"].expand(d.shape).contiguous()
    primary = (o, d.contiguous(), cam["n_clip"].expand(n).contiguous(), cam["f_clip"].expand(n).contiguous())

    t, slot = closest(*primary)[:2]
    hit = slot >= 0
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    n_tri = cs.tri.shape[0]
    rows = cs.tri[torch.clamp(slot, 0, n_tri - 1).long()]
    nrm = torch.cross(rows[:, 3:6], rows[:, 6:9], dim=-1)
    centre = cs.sph[torch.clamp(slot - n_tri, 0, cs.sph.shape[0] - 1).long(), :3]
    nrm = torch.where((slot >= n_tri)[:, None], p - centre, nrm)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True), 1e-30)
    nrm = torch.where(((nrm * d).sum(-1) > 0)[:, None], -nrm, nrm)
    keys = rng.fold_in(rng.prng_key(seed, dev).expand(n, 2), (py.to(torch.int64) * width + px) & rng.MASK32)
    u = rng.uniform(keys, (2,))
    r, phi = torch.sqrt(u[:, 0]), 2 * math.pi * u[:, 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp_min(1 - u[:, 0], 0.0))], -1)
    helper = torch.where(torch.abs(nrm[:, 0:1]) > 0.9, torch.tensor([0.0, 1.0, 0.0], device=dev),
                         torch.tensor([1.0, 0.0, 0.0], device=dev))
    tx = torch.cross(helper, nrm, dim=-1)
    tx = tx / torch.clamp_min(torch.linalg.norm(tx, dim=-1, keepdim=True), 1e-30)
    ty = torch.cross(nrm, tx, dim=-1)
    d2 = local[:, 0:1] * tx + local[:, 1:2] * ty + local[:, 2:3] * nrm
    o2 = (p + nrm * 1e-4).contiguous()
    eps = torch.full((n,), 1e-4, device=dev)
    out = {"camera": primary, "bounce": (o2, d2.contiguous(), eps, torch.where(hit, 1e30, 0.0).contiguous())}
    for code, pos, direction in zip(lights["type"], lights["position"], lights["direction"]):
        if int(code) == LT_DIRECTIONAL:
            wl = torch.as_tensor(direction, dtype=torch.float32, device=dev).expand(n, 3).contiguous()
            t_hi = torch.where(hit, 1e30, 0.0)
        else:
            wl = torch.as_tensor(pos, dtype=torch.float32, device=dev) - p
            dist = torch.linalg.norm(wl, dim=-1, keepdim=True)
            wl = (wl / torch.clamp_min(dist, 1e-9)).contiguous()
            t_hi = torch.where(hit, dist[:, 0] * 0.999, 0.0)
        out[f"shadow_{SHADOW_NAMES[int(code)]}"] = (o2, wl, eps, t_hi.contiguous())
    return out


def measure(r, lights: dict, seed: int) -> dict | None:
    """Kernels A and C of renderer ``r``'s brute-mode scene timed alone on the cell's wavefronts
    (``lanes`` = the renderer's tile), each with its bound: ``{"rows": {name: {kernel, ms, bound_ms,
    bound_by}}, "share": sum of bounds / sum of times}``.  None where the scene is not a brute-mode
    cluster tree."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.scene.camera import camera_params

    cs = r.bundle.cscene
    if cs is None or not cs.brute:
        return None
    cam = camera_params(r.camera, torch.device(r.device))._asdict()
    waves = wavefronts(lambda *rays: ic.tree_closest_hit(cs, *rays), cs, cam, r.width, r.height,
                       int(r.tile_pixels), lights, seed)
    rows, sum_ms, sum_bound = {}, 0.0, 0.0
    for name, rays in waves.items():
        if name.startswith("shadow"):
            def fn(rays=rays):
                return ic.brute_hit(cs, *rays, any_hit=True)
            kernel, w = "C", brute_work(cs.s_real, cs.n_spheres, rays)
        else:
            def fn(rays=rays):
                return ic.tree_closest_hit(cs, *rays)
            kernel, w = "A", roofline.work(cs, "closest", rays, fn())
        ms = roofline.cuda_ms(fn)
        b_ms, by = roofline.bound_ms(w)
        rows[name] = {"kernel": kernel, "ms": ms, "bound_ms": b_ms, "bound_by": by}
        sum_ms += ms
        sum_bound += b_ms
    return {"rows": rows, "share": sum_bound / sum_ms}
