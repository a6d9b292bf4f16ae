"""The plain reference of the config-1 frame: the Cornell box's triangles and spheres under four light kinds.

It extends :class:`benchlib.sky_ref.SkyReference` (the BSDF families of
config 3 by import, the NEE over light slots, the Russian-roulette bounces
on the same threefry tape) and imports nothing of the program.  It takes
only what the benchmark made (:class:`benchlib.cornell_scene.CornellScene`):
the triangles with their normals and material rows, the spheres, the
material list, the light rows, the frame seeds; the camera is placed by the
driver from the numbers the file holds.  It computes, in float32 (the sky's
float64 tables are not needed):

- the trace by brute force over every triangle (``Geometry``: one chunk
  holds the box's 22 triangles) and then every sphere, as the program's
  sphere pass orders it (``ops/intersect_cuda.py:_sphere_pass``, the
  equations of ``lens_flare_tpu/ops/intersect_pallas.py:840``): the
  quadratic's nearer root in [t_lo, min(t_hi, best t)], else the farther,
  a sphere winning only a strictly nearer hit; any hit is a triangle or a
  sphere root within [t_lo, t_hi].  A sphere's normal is the unit vector
  from its centre to the hit point (``ops/intersect.py:finalize_hit``),
  kept as it is on glass;
- NEE over four slots in the light table's order (area, spot, point,
  directional; ``lens_flare_tpu/integrator/lights.py``): the spot light a
  point light scaled by its smooth cone falloff,
  clamp((cos - cos falloff) / (1 - cos falloff), 0, 1) ** exponent;
- emission: an emitter's radiance where a camera ray hits it, and where a
  bounce from a delta lobe (mirror, glass) hits it, weighted by the path's
  throughput (``lens_flare_tpu/integrator/path.py:792-802``); NEE does not
  sample the emitting panel, which is no light;
- :meth:`CornellReference.still`: a pixel's ``ns`` samples summed in
  float32 in sample order and divided by their count, as a tiled frame
  without the adaptive stop sums them.

Departures from the program: besides those of ``SkyReference`` (every lane
carries every family and selects its own), the emitter's row is a diffuse
row of zero albedo beside its radiance, so a bounce off it samples the
cosine hemisphere with f = 0, as the program's emission family does; no
stats are counted.

``lowp=True`` is the control: every radiance quantity rounded to bfloat16,
as :class:`benchlib.reference.Reference` rounds it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng, sky_ref
from .cornell_scene import BSDF, LT_AREA, LT_SPOT, CornellScene
from .reference import CPDF, EPS_F, KINF, LANE_BLOCK, LIGHT_INF, MISS_T, Geometry, Hit, make_coord_space, offset_origin
from .reference import local_to_world, norm3, world_to_local
from .scene import LT_DIRECTIONAL
from .sky_ref import GLASS, MIRROR, dot3

EMISSION = BSDF["emission"]


class Materials(sky_ref.Materials):
    """Config 3's material rows and the emission family: its radiance, and a zero diffuse albedo."""

    def __init__(self, materials: list, device):
        emits = [m["kind"] == "emission" for m in materials]
        super().__init__([{"kind": "diffuse", "albedo": (0, 0, 0)} if e else m for m, e in zip(materials, emits)],
                         device)
        radiance = np.zeros((len(materials), 3), np.float32)
        for i, (m, e) in enumerate(zip(materials, emits)):
            if e:
                radiance[i] = np.asarray(m["radiance"], np.float64)
        self.kind = torch.where(torch.as_tensor(emits, device=device), EMISSION, self.kind)
        self.radiance = torch.as_tensor(radiance, device=device)

    def emission(self, b):
        return torch.where((self.kind[b] == EMISSION)[:, None], self.radiance[b], 0.0)

    def delta(self, b):
        t = self.kind[b]
        return (t == MIRROR) | (t == GLASS)


class Shapes(Geometry):
    """The triangles (``Geometry``), then the spheres, tested by every ray."""

    def __init__(self, scene: CornellScene, device):
        super().__init__(scene.tri_p, scene.tri_n, device)
        self.centre = torch.as_tensor(scene.sph_center, device=device)
        self.radius = torch.as_tensor(scene.sph_radius, device=device)

    def _sphere_roots(self, s: int, o, d, t_lo, limit):
        """(hit, t) of sphere ``s``: the nearer root in [t_lo, limit], else the farther one."""
        c, r = self.centre[s], self.radius[s]
        ocx, ocy, ocz = o[:, 0] - c[0], o[:, 1] - c[1], o[:, 2] - c[2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        a = dx * dx + dy * dy + dz * dz
        bq = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = bq * bq - 4.0 * a * cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-bq - sq) / (2.0 * a)
        t2 = (-bq + sq) / (2.0 * a)
        t1_ok = (t1 >= t_lo) & (t1 <= limit)
        t2_ok = (t2 >= t_lo) & (t2 <= limit)
        return (disc >= 0) & (t1_ok | t2_ok), torch.where(t1_ok, t1, t2)

    def closest_any(self, o, d, t_lo, t_hi):
        """(t, triangle id or -1, sphere index or -1, b1, b2) of the nearest triangle or sphere."""
        t, tid, b1, b2, found = self.closest(o, d, t_lo, t_hi)
        best = torch.where(found, t, KINF)
        sph = torch.full_like(tid, -1)
        for s in range(self.centre.shape[0]):
            ok, ts = self._sphere_roots(s, o, d, t_lo, torch.minimum(t_hi, best))
            better = ok & (ts < best)
            best = torch.where(better, ts, best)
            sph = torch.where(better, s, sph)
        return best, torch.where(sph >= 0, -1, tid), sph, b1, b2

    def occluded(self, o, d, t_lo, t_hi):
        occ = super().occluded(o, d, t_lo, t_hi)
        for s in range(self.centre.shape[0]):
            occ = occ | self._sphere_roots(s, o, d, t_lo, t_hi)[0]
        return occ


class CornellReference(sky_ref.SkyReference):
    """The plain reference of one config-1 scene (``settings``: ``max_ray_depth``, ``indirect`` and the
    render ``seed``)."""

    def __init__(self, scene: CornellScene, settings: dict, device, lowp: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = torch.device(device)
        self.lowp = lowp
        self.geo = Shapes(scene, self.dev)
        self.tri_bsdf = torch.as_tensor(scene.tri_bsdf, dtype=torch.int64, device=self.dev)
        self.sph_bsdf = torch.as_tensor(scene.sph_bsdf, dtype=torch.int64, device=self.dev)
        self.mats = Materials(scene.materials, self.dev)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.dev)

        self.light_types = [int(c) for c in scene.light_type]
        self.light_rad, self.light_pos, self.light_dir = t(scene.light_radiance), t(scene.light_position), \
            t(scene.light_direction)
        self.light_dim_x, self.light_dim_y, self.light_area = t(scene.light_dim_x), t(scene.light_dim_y), \
            t(scene.light_area)
        self.depth = int(settings["max_ray_depth"])
        self.indirect = bool(settings.get("indirect", True))
        self.seed = int(settings["seed"])
        self.bokeh = None

    @property
    def n_slots(self) -> int:
        return len(self.light_types)  # every light one slot (ns_area_light 1)

    # -- trace -------------------------------------------------------------

    def _closest(self, o, d, t_lo, t_hi) -> Hit:
        t, tid, sph, b1, b2 = self.geo.closest_any(o, d, t_lo, t_hi)
        tri, ball = tid >= 0, sph >= 0
        found = tri | ball
        t = torch.where(found, t, MISS_T)
        rows = self.geo.normals[torch.clamp_min(tid, 0)]
        b0 = 1.0 - b1 - b2
        n_tri = b0[:, None] * rows[:, 0:3] + b1[:, None] * rows[:, 3:6] + b2[:, None] * rows[:, 6:9]
        n_tri = n_tri / torch.clamp_min(norm3(n_tri), 1e-30)[:, None]
        n_sph = o + d * t[:, None] - self.geo.centre[torch.clamp_min(sph, 0)]
        n_sph = n_sph / torch.clamp_min(norm3(n_sph), 1e-30)[:, None]
        n = torch.where(tri[:, None], n_tri, torch.where(ball[:, None], n_sph, 0.0))
        bsdf = torch.where(tri, self.tri_bsdf[torch.clamp_min(tid, 0)],
                           torch.where(ball, self.sph_bsdf[torch.clamp_min(sph, 0)], 0))
        backface = dot3(n, d) > 0
        flip = backface & (self.mats.kind[bsdf] != GLASS) & found
        hit = Hit(t, torch.where(flip[:, None], -n, n), found)
        hit.bsdf = bsdf
        return hit

    # -- the estimator -----------------------------------------------------

    def _light_samples(self, u, hit_p):
        """(radiance, wi, dist, pdf) of each slot, the slots one after another: (S * N, ...)."""
        n_pts = hit_p.shape[0]
        rad, wi, dist, pdf = [], [], [], []
        for row, code in enumerate(self.light_types):
            r = self.light_rad[row].expand(n_pts, 3)
            ones = torch.ones(n_pts, device=self.dev)
            if code == LT_AREA:  # a point of the rectangle, pdf in solid angle; it shines down its facing
                uv = u[:, 2 * row : 2 * row + 2] - 0.5
                v = (self.light_pos[row] + uv[:, 0:1] * self.light_dim_x[row] + uv[:, 1:2] * self.light_dim_y[row]
                     - hit_p)
                cos_theta = dot3(v, self.light_dir[row])
                sq_dist = dot3(v, v)
                dl = torch.sqrt(sq_dist)
                wi.append(v / torch.clamp_min(dl, 1e-30)[:, None])
                dist.append(dl)
                pdf.append(sq_dist / torch.clamp_min(self.light_area[row] * torch.abs(cos_theta), 1e-30))
                rad.append(torch.where((cos_theta < 0)[:, None], r, 0.0))
            elif code == LT_DIRECTIONAL:  # the sun
                rad.append(r)
                wi.append(self.light_dir[row].expand(n_pts, 3))
                dist.append(torch.full((n_pts,), LIGHT_INF, device=self.dev))
                pdf.append(ones)
            else:  # point and spot: toward the light's position
                v = self.light_pos[row] - hit_p
                dl = norm3(v)
                w = v / torch.clamp_min(dl, 1e-30)[:, None]
                if code == LT_SPOT:
                    cos_cone, exponent = self.light_dim_x[row, 0], self.light_dim_x[row, 1]
                    cos_dir = dot3(-w, self.light_dir[row].expand(n_pts, 3))
                    base = torch.clamp((cos_dir - cos_cone) / torch.clamp_min(1.0 - cos_cone, 1e-6), 0.0, 1.0)
                    r = r * (base ** torch.clamp_min(exponent, 1e-6))[:, None]
                rad.append(r)
                wi.append(w)
                dist.append(dl)
                pdf.append(ones)
        return tuple(torch.cat(x) for x in (rad, wi, dist, pdf))

    def radiance(self, cam, px, py, s_idx, width: int, height: int):
        n_lanes = px.shape[0]
        s = self.n_slots
        u_len = 4 + 2 * s + max(self.depth - 1, 0) * (4 + 2 * s)
        base = rng.fold_in(rng.prng_key(self.seed, self.dev).expand(n_lanes, 2),
                           (py.to(torch.int64) * width + px) & rng.MASK32)
        tape = rng.uniform(rng.fold_in(base, s_idx), (u_len,))
        x = (px.to(torch.float32) + tape[:, 0]) / width
        y = (py.to(torch.float32) + tape[:, 1]) / height
        o, d = self._rays(cam, x, y, None, None)
        hit = self._closest(o.contiguous(), d.contiguous(), cam["n_clip"].expand(n_lanes),
                            cam["f_clip"].expand(n_lanes))
        hit_p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]
        frame0 = make_coord_space(hit.n)
        w_out0 = world_to_local(frame0, -d)
        L = self.q(self.mats.emission(hit.bsdf) + self._direct(
            tape[:, 4 : 4 + 2 * s], hit_p, hit.n, (frame0, w_out0), self._nee_active(hit, hit.hit), hit.bsdf))
        if self.indirect and self.depth > 1:
            L = self.q(L + self._indirect(tape[:, 4 + 2 * s :], o, d, hit, (frame0, w_out0)))
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
            cont = active & (u_b[:, 0] >= (1.0 - CPDF))
            f, wi, pdf, valid = self.mats.sample_f(cur_hit.bsdf, w_out, u_b[:, 1:4])
            f = self.q(f)
            cont = cont & valid & (pdf > 0)
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
            # an emitter seen through a delta lobe, which NEE cannot sample
            seen = cont & self.mats.delta(cur_hit.bsdf)
            L = self.q(L + torch.where(seen[:, None], throughput * self.mats.emission(nxt.bsdf), 0.0))
            nxt_p = hit_p + wi_world * nxt.t[:, None]
            o2w_n = make_coord_space(nxt.n)
            w_out_n = world_to_local(o2w_n, -wi_world)
            Ld = self._direct(u_b[:, 4:], nxt_p, nxt.n, (o2w_n, w_out_n), self._nee_active(nxt, cont), nxt.bsdf)
            L = self.q(L + torch.where(cont[:, None], throughput * Ld, 0.0))
            cur_o, cur_d, cur_hit, o2w, w_out, active = hit_p, wi_world, nxt, o2w_n, w_out_n, cont
        return L

    # -- the frame ---------------------------------------------------------

    def still(self, cam, px, py, width: int, height: int, ns: int):
        """The tiled frame's radiance at pixels (px, py): samples 0 .. ns-1 summed in float32 in order,
        over their count."""
        film = torch.zeros((px.shape[0], 3), device=self.dev)
        for s in range(ns):
            film = self.q(film + self._samples(cam, px, py, s, width, height))
        return film / torch.full((px.shape[0],), ns, dtype=torch.int32, device=self.dev)[:, None]

    def first_hits_all(self, cam, px, py, width: int, height: int, ns: int):
        """The material rows the camera rays of samples 0 .. ns-1 hit at pixels (px, py) (-1: nothing)."""
        out = []
        for s in range(ns):
            for i in range(0, px.shape[0], LANE_BLOCK):
                p, q = px[i : i + LANE_BLOCK], py[i : i + LANE_BLOCK]
                base = rng.fold_in(rng.prng_key(self.seed, self.dev).expand(p.shape[0], 2),
                                   (q.to(torch.int64) * width + p) & rng.MASK32)
                tape = rng.uniform(rng.fold_in(base, torch.full_like(p, s)), (2,))
                o, d = self._rays(cam, (p.to(torch.float32) + tape[:, 0]) / width,
                                  (q.to(torch.float32) + tape[:, 1]) / height, None, None)
                hit = self._closest(o.contiguous(), d.contiguous(), cam["n_clip"].expand(p.shape[0]),
                                    cam["f_clip"].expand(p.shape[0]))
                out.append(torch.where(hit.hit, hit.bsdf, -1))
        return torch.cat(out)
