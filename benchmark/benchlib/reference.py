"""The plain reference: the cells' frames recomputed in plain PyTorch, pixel by pixel.

It imports nothing of the program and takes nothing the program made.  From
the benchmark's own terrain arrays (:mod:`benchlib.scene`) it builds its own
acceleration structure: triangles sorted along a Morton curve of their
centroids, cut into chunks of ``CHUNK`` with a padded box each, rays tested
against every chunk box and then by brute force against the triangles of the
chunks they enter.  On top of that trace it computes the estimator the
program renders, on the same threefry tape (:mod:`benchlib.rng`): a frozen,
plain copy of ``lens_flare_tpu_torch/integrator/path.py``,
``integrator/shading.py``, ``integrator/lights.py``, ``ops/intersect.py:
finalize_hit`` and ``scene/camera.py``'s ray generation, cut down to what
the terrain holds (one diffuse material, a directional and a point light,
triangles only) and written in the program's order of operations, so that
a sound run agrees to rounding.

Every pixel's estimate depends only on (seed, pixel, sample index, camera),
so the reference renders the sampled pixels alone: a tiled 1-spp frame
(:meth:`Reference.tiled`), the adaptive frame's stages with their 95% CI
stop (:meth:`Reference.adaptive`) and the progressive viewer's accumulated
film (:meth:`Reference.progressive`).

``lowp=True`` is the control: the same computation with every radiance
quantity (BSDF values, light contributions, throughput, each sample's
radiance and the film sums) rounded to bfloat16, the precision below the
configurations' float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .scene import LT_DIRECTIONAL, LT_POINT, Terrain

EPS_F = 0.00001
CPDF = 0.7  # russian-roulette continuation probability
SHADOW_BIAS = 1e-4
MISS_T = 1e30  # the distance the program gives a missed ray
LIGHT_INF = 1e30  # a directional light's distance
KINF = 3.0e38
CHUNK = 64  # triangles per chunk of the reference's own structure
RAY_BLOCK = 2048  # rays per box-test block
PAIR_BLOCK = 8192  # (ray, chunk) pairs per triangle-test block
LANE_BLOCK = 16384  # lanes per radiance block


# -- geometry helpers (the program's order of operations) --------------------


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def make_coord_space(n):
    smallest = torch.argmin(torch.abs(n), dim=-1)
    h = torch.where(torch.arange(3, device=n.device) == smallest[:, None], 1.0, n)
    z = n / torch.clamp_min(norm3(n), 1e-30)[:, None]
    y = cross(h, z)
    y = y / torch.clamp_min(norm3(y), 1e-30)[:, None]
    x = cross(z, y)
    x = x / torch.clamp_min(norm3(x), 1e-30)[:, None]
    return torch.stack([x, y, z], dim=-1)


def world_to_local(o2w, v):
    return torch.stack(
        [o2w[:, 0, j] * v[:, 0] + o2w[:, 1, j] * v[:, 1] + o2w[:, 2, j] * v[:, 2] for j in range(3)], dim=-1
    )


def local_to_world(o2w, v):
    return torch.stack(
        [o2w[:, i, 0] * v[:, 0] + o2w[:, i, 1] * v[:, 1] + o2w[:, i, 2] * v[:, 2] for i in range(3)], dim=-1
    )


def offset_origin(p, n, w):
    side = torch.sign(n[:, 0] * w[:, 0] + n[:, 1] * w[:, 1] + n[:, 2] * w[:, 2])[:, None]
    scale = SHADOW_BIAS * torch.clamp_min(torch.abs(p).amax(dim=-1, keepdim=True), 1.0)
    return p + n * side * scale


def mt_terms(tri, o, d):
    """Möller-Trumbore numerators of triangle rows [p0 | e1 | e2] against rays."""
    p0 = [tri[..., j] for j in range(3)]
    e1 = [tri[..., 3 + j] for j in range(3)]
    e2 = [tri[..., 6 + j] for j in range(3)]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    sx, sy, sz = ox - p0[0], oy - p0[1], oz - p0[2]
    s1x = dy * e2[2] - dz * e2[1]
    s1y = dz * e2[0] - dx * e2[2]
    s1z = dx * e2[1] - dy * e2[0]
    s2x = sy * e1[2] - sz * e1[1]
    s2y = sz * e1[0] - sx * e1[2]
    s2z = sx * e1[1] - sy * e1[0]
    det = s1x * e1[0] + s1y * e1[1] + s1z * e1[2]
    tt_n = s2x * e2[0] + s2y * e2[1] + s2z * e2[2]
    bb1_n = s1x * sx + s1y * sy + s1z * sz
    bb2_n = s2x * dx + s2y * dy + s2z * dz
    return det, tt_n, bb1_n, bb2_n


def occludes(det, tt_n, bb1_n, bb2_n, t_lo, t_hi):
    sgn = torch.where(det >= 0, 1.0, -1.0)
    adet = det * sgn
    tts = tt_n * sgn
    b1s = bb1_n * sgn
    b2s = bb2_n * sgn
    return (
        (adet > 0) & (tts >= t_lo * adet) & (tts <= t_hi * adet)
        & (b1s >= 0) & (b1s <= adet) & (b2s >= 0) & (b2s <= adet) & (b1s + b2s <= adet)
    )


def closest_terms(det, tt_n, bb1_n, bb2_n, t_lo, limit):
    inv_det = 1.0 / torch.where(det == 0, 1e-30, det)
    tt = tt_n * inv_det
    b1 = bb1_n * inv_det
    b2 = bb2_n * inv_det
    valid = (
        (det != 0) & (tt >= t_lo) & (tt <= limit)
        & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b2 <= 1) & (b1 + b2 <= 1)
    )
    return valid, tt, b1, b2


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points scaled to [0, 1023]^3."""
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = np.clip(((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class Geometry:
    """The reference's trace: chunk boxes, then brute force inside the chunks a ray enters."""

    def __init__(self, tri_p: np.ndarray, tri_n: np.ndarray, device):
        tri_p = np.asarray(tri_p, np.float32)
        n_t = len(tri_p)
        order = np.argsort(_morton(tri_p.mean(axis=1, dtype=np.float64)), kind="stable")
        n_pad = -(-n_t // CHUNK) * CHUNK
        rows = np.zeros((n_pad, 9), np.float32)  # padding rows: e1 = e2 = 0, never hit
        rows[:n_t, 0:3] = tri_p[order, 0]
        rows[:n_t, 3:6] = tri_p[order, 1] - tri_p[order, 0]
        rows[:n_t, 6:9] = tri_p[order, 2] - tri_p[order, 0]
        ids = np.full(n_pad, -1, np.int64)
        ids[:n_t] = order
        corners = np.concatenate([tri_p[order], np.repeat(tri_p[order[-1:]], n_pad - n_t, axis=0)])
        corners = corners.reshape(-1, CHUNK * 3, 3).astype(np.float64)
        lo, hi = corners.min(axis=1), corners.max(axis=1)
        pad = 1e-4 * (np.abs(lo) + np.abs(hi) + 1.0)
        self.boxes = torch.as_tensor(np.concatenate([lo - pad, hi + pad], axis=1).astype(np.float32), device=device)
        self.rows = torch.as_tensor(rows.reshape(-1, CHUNK, 9), device=device)
        self.ids = torch.as_tensor(ids.reshape(-1, CHUNK), device=device)
        self.tri_rows = torch.as_tensor(
            np.concatenate([tri_p[:, 0], tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0]], axis=1), device=device
        )
        self.normals = torch.as_tensor(np.asarray(tri_n, np.float32).reshape(n_t, 9), device=device)

    def _pairs(self, o, d, t_lo, t_hi):
        """(lane, chunk) pairs whose padded box the ray enters within [t_lo, t_hi], per ray block."""
        for i in range(0, o.shape[0], RAY_BLOCK):
            sl = slice(i, i + RAY_BLOCK)
            ob, db = o[sl].double(), d[sl].double()
            inv = 1.0 / torch.where(db >= 0, torch.clamp_min(db, 1e-12), torch.clamp_max(db, -1e-12))
            bx = self.boxes.double()
            t_min = t_max = None
            for a in range(3):
                t1 = (bx[None, :, a] - ob[:, a, None]) * inv[:, a, None]
                t2 = (bx[None, :, 3 + a] - ob[:, a, None]) * inv[:, a, None]
                lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
                t_min = lo if t_min is None else torch.maximum(t_min, lo)
                t_max = hi if t_max is None else torch.minimum(t_max, hi)
            lo_b = t_lo[sl].double()[:, None] - 1e-3
            hi_b = t_hi[sl].double()[:, None] * (1 + 1e-5) + 1e-3
            ok = (t_min <= t_max) & (t_max >= lo_b) & (t_min <= hi_b) & (t_lo[sl] <= t_hi[sl])[:, None]
            lane, chunk = ok.nonzero(as_tuple=True)
            for j in range(0, lane.shape[0], PAIR_BLOCK):
                yield lane[j : j + PAIR_BLOCK] + i, chunk[j : j + PAIR_BLOCK]

    def closest(self, o, d, t_lo, t_hi):
        """(t, tri id, b1, b2, found): the least t over every triangle, ties to the lowest id."""
        n = o.shape[0]
        big = torch.iinfo(torch.int64).max
        best_t = torch.full((n,), KINF, device=o.device)
        best_id = torch.full((n,), big, dtype=torch.int64, device=o.device)
        for lane, chunk in self._pairs(o, d, t_lo, t_hi):
            terms = mt_terms(self.rows[chunk], o[lane, None, :], d[lane, None, :])
            valid, tt, _, _ = closest_terms(*terms, t_lo[lane, None], t_hi[lane, None])
            tm = torch.where(valid, tt, KINF)
            pmin = tm.min(dim=1).values
            pid = torch.where(valid & (tt == pmin[:, None]), self.ids[chunk], big).min(dim=1).values
            lane_min = torch.full((n,), KINF, device=o.device).scatter_reduce(0, lane, pmin, "amin")
            cand = torch.where(pmin == lane_min[lane], pid, big)
            lane_id = torch.full((n,), big, dtype=torch.int64, device=o.device).scatter_reduce(0, lane, cand, "amin")
            better = lane_min < best_t
            tie = (lane_min == best_t) & (lane_min < KINF)
            best_id = torch.where(better, lane_id, torch.where(tie, torch.minimum(best_id, lane_id), best_id))
            best_t = torch.where(better, lane_min, best_t)
        found = best_id < big
        tid = torch.where(found, best_id, 0)
        # the winner's t and barycentrics, computed as the pair test computed them
        det, tt_n, bb1_n, bb2_n = mt_terms(self.tri_rows[tid], o, d)
        _, tt, b1, b2 = closest_terms(det, tt_n, bb1_n, bb2_n, t_lo, t_hi)
        return tt, torch.where(found, best_id, -1), b1, b2, found

    def occluded(self, o, d, t_lo, t_hi):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for lane, chunk in self._pairs(o, d, t_lo, t_hi):
            terms = mt_terms(self.rows[chunk], o[lane, None, :], d[lane, None, :])
            hit = occludes(*terms, t_lo[lane, None], t_hi[lane, None]).any(dim=1)
            occ[lane[hit]] = True
        return occ


class Hit:
    def __init__(self, t, n, hit):
        self.t, self.n, self.hit = t, n, hit


def make_bokeh_cdf(values, device) -> torch.Tensor:
    """The aperture mask's value CDF, built in float64 and cast to float32."""
    v = np.asarray(values, np.float64).ravel()
    cdf = np.cumsum(v)
    return torch.as_tensor((cdf / cdf[-1]).astype(np.float32), device=device)


class Reference:
    """The plain reference of one terrain scene under one configuration's settings.

    ``settings``: ``max_ray_depth``, ``indirect`` and the render ``seed``;
    ``bokeh`` (an (H, W) mask) turns on thin-lens bokeh rays.
    """

    def __init__(self, terrain: Terrain, settings: dict, device, bokeh=None, lowp: bool = False):
        if sorted(terrain.light_type.tolist()) != [LT_DIRECTIONAL, LT_POINT]:
            raise ValueError("the reference renders the terrain's directional sun and point light")
        self.dev = torch.device(device)
        self.geo = Geometry(terrain.tri_p, terrain.tri_n, self.dev)
        self.albedo = torch.as_tensor(terrain.albedo, device=self.dev)
        self.light_types = [int(t) for t in terrain.light_type]  # every light is delta: one slot each
        self.light_rad = torch.as_tensor(terrain.light_radiance, device=self.dev)
        self.light_pos = torch.as_tensor(terrain.light_position, device=self.dev)
        self.light_dir = torch.as_tensor(terrain.light_direction, device=self.dev)
        self.depth = int(settings["max_ray_depth"])
        self.indirect = bool(settings.get("indirect", True))
        self.seed = int(settings["seed"])
        self.bokeh = None
        if bokeh is not None:
            self.bokeh = (make_bokeh_cdf(bokeh, self.dev), bokeh.shape[1], bokeh.shape[0])
        self.lowp = lowp

    def q(self, x):
        """The control's rounding: bfloat16 where ``lowp``, else nothing."""
        return x.to(torch.bfloat16).to(torch.float32) if self.lowp else x

    # -- camera ------------------------------------------------------------

    def camera(self, params: dict) -> dict:
        return {k: torch.as_tensor(v, dtype=torch.float32, device=self.dev) for k, v in params.items()}

    @staticmethod
    def _to_world(c, v):
        return torch.stack([v[:, 0] * c[i, 0] + v[:, 1] * c[i, 1] + v[:, 2] * c[i, 2] for i in range(3)], dim=-1)

    def _rays(self, cam, x, y, u_r, u_t):
        cx = cam["tan_half_h"] * (2.0 * x - 1.0)
        cy = cam["tan_half_v"] * (2.0 * y - 1.0)
        if self.bokeh is None:
            d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
            d_cam = d_cam / norm3(d_cam)[:, None]
            d = self._to_world(cam["c2w"], d_cam)
            return cam["pos"].expand(d.shape), d
        cdf, bw, bh = self.bokeh
        n = cdf.shape[0]
        idx = torch.clamp(torch.searchsorted(cdf, u_r.contiguous(), right=True), 0, n - 1)
        lo = torch.where(idx > 0, cdf[torch.clamp_min(idx - 1, 0)], 0.0)
        span = torch.clamp_min(cdf[idx] - lo, 1e-12)
        jy = torch.clamp((u_r - lo) / span, 0.0, 1.0)
        lens_uv = torch.stack(
            [(idx % bw).to(torch.float32) + u_t, (idx // bw).to(torch.float32) + jy], dim=-1
        )
        lens_uv = torch.stack([lens_uv[:, 0] / bw - 0.5, lens_uv[:, 1] / bh - 0.5], dim=-1)
        scale = 2.0 * cam["lens_radius"]
        p_lens = torch.stack([lens_uv[:, 0] * scale, lens_uv[:, 1] * scale, torch.zeros_like(lens_uv[:, 0])], dim=-1)
        p_focus = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1) * cam["focal_distance"]
        d_cam = p_focus - p_lens
        d_cam = d_cam / norm3(d_cam)[:, None]
        c = cam["c2w"]
        return cam["pos"] + self._to_world(c, p_lens), self._to_world(c, d_cam)

    def focus(self, cam: dict, x: float, y: float) -> float:
        """The hit distance under the pinhole ray through (x, y) of a width x height film (autofocus)."""
        bokeh, self.bokeh = self.bokeh, None
        try:
            o, d = self._rays(cam, torch.tensor([x], device=self.dev), torch.tensor([y], device=self.dev), None, None)
        finally:
            self.bokeh = bokeh
        t, _, _, _, found = self.geo.closest(o.contiguous(), d, cam["n_clip"].reshape(1), cam["f_clip"].reshape(1))
        return float(torch.where(found, t, MISS_T)[0])

    # -- trace -------------------------------------------------------------

    def _closest(self, o, d, t_lo, t_hi) -> Hit:
        t, tid, b1, b2, found = self.geo.closest(o, d, t_lo, t_hi)
        t = torch.where(found, t, MISS_T)
        rows = self.geo.normals[torch.clamp_min(tid, 0)]
        n0, n1, n2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        b0 = 1.0 - b1 - b2
        n_tri = b0[:, None] * n0 + b1[:, None] * n1 + b2[:, None] * n2
        nrm = torch.sqrt(n_tri[:, 0] * n_tri[:, 0] + n_tri[:, 1] * n_tri[:, 1] + n_tri[:, 2] * n_tri[:, 2])
        n_tri = n_tri / torch.clamp_min(nrm, 1e-30)[:, None]
        n = torch.where(found[:, None], n_tri, torch.zeros_like(o))
        backface = (n[:, 0] * d[:, 0] + n[:, 1] * d[:, 1] + n[:, 2] * d[:, 2]) > 0
        n = torch.where((backface & found)[:, None], -n, n)
        return Hit(t, n, found)

    # -- the estimator -----------------------------------------------------

    def _direct(self, u, hit_p, n, frame, active):
        o2w, w_out = frame
        n_pts = hit_p.shape[0]
        n_slots = len(self.light_types)

        def rep(x):
            return x.repeat((n_slots,) + (1,) * (x.dim() - 1))

        rad, wi, dist, pdf = [], [], [], []
        for row, code in enumerate(self.light_types):
            rad.append(self.light_rad[row].expand(n_pts, 3))
            pdf.append(torch.ones(n_pts, device=self.dev))
            if code == LT_DIRECTIONAL:
                wi.append(self.light_dir[row].expand(n_pts, 3))
                dist.append(torch.full((n_pts,), LIGHT_INF, device=self.dev))
            else:
                v = self.light_pos[row] - hit_p
                dl = norm3(v)
                wi.append(v / torch.clamp_min(dl, 1e-30)[:, None])
                dist.append(dl)
        ls_rad, ls_wi, ls_dist, ls_pdf = (torch.cat(x) for x in (rad, wi, dist, pdf))
        wi_obj = world_to_local(rep(o2w), ls_wi)
        live = (wi_obj[:, 2] >= 0) & (ls_pdf > 0) & rep(active)
        cos_theta = wi_obj[:, 2] / torch.clamp_min(norm3(wi_obj), 1e-30)
        f = self.q((self.albedo / math.pi).expand(n_slots * n_pts, 3))
        weight = torch.where(live, cos_theta / torch.clamp_min(ls_pdf, 1e-30), 0.0)
        contrib = self.q(torch.where(live[:, None], f, 0.0) * ls_rad * weight[:, None])
        occ = self.geo.occluded(
            offset_origin(rep(hit_p), rep(n), ls_wi), ls_wi,
            torch.full((n_slots * n_pts,), EPS_F, device=self.dev),
            torch.where(live, ls_dist * (1.0 - 1e-3) - EPS_F, 0.0),
        )
        contrib = torch.where((live & ~occ)[:, None], contrib, 0.0)
        return self.q(contrib.view(n_slots, n_pts, 3).sum(dim=0) / n_slots)

    def radiance(self, cam, px, py, s_idx, width: int, height: int):
        """One sample of each lane: pixel (px, py), sample index ``s_idx`` (all (N,) tensors) -> (N, 3)."""
        n_lanes = px.shape[0]
        n_slots = len(self.light_types)
        u_len = 4 + 2 * n_slots + max(self.depth - 1, 0) * (4 + 2 * n_slots)
        base = rng.fold_in(rng.prng_key(self.seed, self.dev).expand(n_lanes, 2), (py.to(torch.int64) * width + px) & rng.MASK32)
        tape = rng.uniform(rng.fold_in(base, s_idx), (u_len,))
        x = (px.to(torch.float32) + tape[:, 0]) / width
        y = (py.to(torch.float32) + tape[:, 1]) / height
        o, d = self._rays(cam, x, y, tape[:, 2], tape[:, 3])
        hit = self._closest(o.contiguous(), d.contiguous(), cam["n_clip"].expand(n_lanes), cam["f_clip"].expand(n_lanes))
        hit_p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]
        frame0 = make_coord_space(hit.n)
        w_out0 = world_to_local(frame0, -d)
        L = self._direct(tape[:, 4 : 4 + 2 * n_slots], hit_p, hit.n, (frame0, w_out0), hit.hit)
        if self.indirect and self.depth > 1:
            L = self.q(L + self._indirect(tape[:, 4 + 2 * n_slots :], o, d, hit, (frame0, w_out0)))
        return self.q(torch.where(hit.hit[:, None], L, 0.0))

    def _indirect(self, tape, o, d, hit, frame):
        n_lanes = o.shape[0]
        n_bounces = self.depth - 1
        tape_b = tape.reshape(n_lanes, n_bounces, tape.shape[1] // n_bounces)
        cur_o, cur_d, cur_hit = o, d, hit
        o2w, w_out = frame
        throughput = torch.ones((n_lanes, 3), device=self.dev)
        active = hit.hit
        L = torch.zeros((n_lanes, 3), device=self.dev)
        for bounce in range(1, self.depth):
            u_b = tape_b[:, bounce - 1]
            depth_remaining = self.depth - (bounce - 1)
            cont = active & (depth_remaining > 1) & (u_b[:, 0] >= (1.0 - CPDF))
            # cosine-weighted hemisphere sample of the diffuse BSDF
            xi1, xi2 = u_b[:, 1], u_b[:, 2]
            r = torch.sqrt(xi1)
            phi = 2.0 * math.pi * xi2
            z_cos = torch.sqrt(torch.clamp_min(1.0 - xi1, 0.0))
            wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z_cos], dim=-1)
            pdf = z_cos / math.pi
            f = self.q((self.albedo / math.pi).expand(n_lanes, 3))
            cont = cont & (pdf > 0)
            wi_world = local_to_world(o2w, wi)
            safe_t = torch.where(cur_hit.hit, cur_hit.t, 0.0)
            hit_p = cur_o + cur_d * safe_t[:, None]
            b_o = offset_origin(hit_p, cur_hit.n, wi_world)
            b_hi = torch.where(cont, 1e30, 0.0)
            nxt = self._closest(b_o, wi_world, torch.full((n_lanes,), EPS_F, device=self.dev), b_hi)
            cont = cont & nxt.hit
            cos_theta = torch.abs(wi[:, 2]) / torch.clamp_min(norm3(wi), 1e-30)
            step = f * (cos_theta / (pdf * CPDF))[:, None]
            throughput = self.q(torch.where(cont[:, None], throughput * step, throughput))
            nxt_p = hit_p + wi_world * nxt.t[:, None]
            o2w_n = make_coord_space(nxt.n)
            w_out_n = world_to_local(o2w_n, -wi_world)
            Ld = self._direct(u_b[:, 4:], nxt_p, nxt.n, (o2w_n, w_out_n), cont)
            L = self.q(L + torch.where(cont[:, None], throughput * Ld, 0.0))
            cur_o, cur_d, cur_hit, o2w, w_out, active = hit_p, wi_world, nxt, o2w_n, w_out_n, cont
        return L

    # -- the frames --------------------------------------------------------

    def _samples(self, cam, px, py, s, width, height):
        """Sample ``s`` (an int) of every lane, in blocks of LANE_BLOCK lanes."""
        out = []
        for i in range(0, px.shape[0], LANE_BLOCK):
            p, q = px[i : i + LANE_BLOCK], py[i : i + LANE_BLOCK]
            out.append(self.radiance(cam, p, q, torch.full_like(p, s, dtype=torch.int64), width, height))
        return torch.cat(out)

    def tiled(self, cam, px, py, width: int, height: int):
        """A 1-spp tiled frame's radiance at the pixels (px, py)."""
        rad = self._samples(cam, px, py, 0, width, height)
        return rad / torch.ones(px.shape[0], dtype=torch.int32, device=self.dev)[:, None]

    def adaptive(self, cam, px, py, width: int, height: int, ns_aa: int, spb: int, tol: float):
        """The adaptive frame's (radiance, sample counts) at the pixels: stages spb, spb, 2 spb, ...,
        per-stage float32 sums added in float64, the 95% CI stop after each stage."""
        spb = min(spb, ns_aa)
        schedule, done, step = [], 0, spb
        while done < ns_aa:
            schedule.append(min(step, ns_aa - done))
            done += schedule[-1]
            if len(schedule) >= 2:
                step *= 2
        n = px.shape[0]
        film = torch.zeros((n, 3), device=self.dev)
        s1 = torch.zeros(n, dtype=torch.float64, device=self.dev)
        s2 = torch.zeros(n, dtype=torch.float64, device=self.dev)
        count = torch.zeros(n, dtype=torch.int32, device=self.dev)
        active = torch.arange(n, device=self.dev)
        s_done = 0
        for ns in schedule:
            if active.shape[0] == 0:
                break
            f = torch.zeros((active.shape[0], 3), device=self.dev)
            a1 = torch.zeros(active.shape[0], device=self.dev)
            a2 = torch.zeros(active.shape[0], device=self.dev)
            for j in range(ns):
                rad = self._samples(cam, px[active], py[active], s_done + j, width, height)
                illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
                f = self.q(f + rad)
                a1 = self.q(a1 + illum)
                a2 = self.q(a2 + illum * illum)
            film.index_add_(0, active, f)
            s1.index_add_(0, active, a1.double())
            s2.index_add_(0, active, a2.double())
            count[active] += ns
            s_done += ns
            nc = torch.clamp_min(count[active], 2).double()
            b1, b2 = s1[active], s2[active]
            var = torch.clamp_min(b2 - b1 * b1 / nc, 0.0) / (nc - 1.0)
            ci = 1.96 * torch.sqrt(var / nc)
            active = active[ci > tol * b1 / nc]
        return film / torch.clamp_min(count, 1)[:, None], count

    def progressive(self, cam, px, py, width: int, height: int, n_samples: int):
        """The viewer's film after samples 0 .. n_samples-1, one added per frame, over their count."""
        film = torch.zeros((px.shape[0], 3), device=self.dev)
        for s in range(n_samples):
            film = self.q(film + self._samples(cam, px, py, s, width, height))
        return film / torch.clamp_min(torch.full((px.shape[0],), n_samples, dtype=torch.int32, device=self.dev), 1)[:, None]


EXPOSURE = float(np.sqrt(2.0 ** 1.0))
GAMMA = 2.2


def to_color(hdr: np.ndarray) -> np.ndarray:
    """HDR -> [0, 1] display values: clamp((c * sqrt 2) ** (1 / 2.2), 0, 1)."""
    scaled = np.maximum(hdr * EXPOSURE, 0.0)
    return np.clip(scaled ** (1.0 / GAMMA), 0.0, 1.0)


def to_8bit(ldr: np.ndarray) -> np.ndarray:
    """[0, 1] display values -> 8-bit levels, as a PNG stores them."""
    return np.clip(np.round(np.asarray(ldr) * 255.0), 0, 255).astype(np.uint8)
