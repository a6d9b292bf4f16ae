"""The plain reference of the config-3 frame: four BSDF families, an area light and an HDR sky.

It extends the frozen integrator of :mod:`benchlib.reference` (its trace,
camera rays, threefry tape and frames) by subclassing, and imports nothing
of the program.  It takes only what the benchmark made
(:class:`benchlib.sky_scene.SkyScene`): the triangles, each triangle's
material, the light rows, the sky's texels as written (HALF-rounded) and
the frame seeds; the camera is placed by the driver from the numbers the
file holds.  On the same threefry tape as the program it computes:

- each BSDF family's evaluation and sampling, written one function per
  family from the equations of ``lens_flare_tpu/integrator/shading.py``
  (line numbers cited beside each): diffuse, Beckmann microfacet with
  conductor Fresnel, mirror, and glass with Schlick's dielectric Fresnel.
  The uniforms map to directions as the equations say; the arithmetic is
  arranged anew (the Beckmann half vector from tan^2 theta_h, not from its
  arctangent; its pdf as D(h) cos_h / (4 wo.h); the rational fits in Horner
  form), so the results agree with the program's to float32 rounding, not
  bit for bit.  Normals face the ray except on glass, whose side tells
  entering from exiting;
- NEE over three slots, in the light table's order: the sun, the area light
  (``lens_flare_tpu/integrator/lights.py``) and the sky, at diffuse and
  microfacet vertices only;
- the sky (``lens_flare_tpu/integrator/envlight.py``, environment_light.cpp):
  its CDFs built in float64 on the host and stored as float32; a sample's
  row and column inverted by counting ``cdf <= u`` over the whole marginal
  and over the whole row (the JAX package's plain count; the program
  searches the row by halving), its pdf, and the wrap-around bilerp where a
  camera ray misses.

Departures from the program: every lane carries all four families and
selects its own (the program leaves out the families a scene lacks, which
changes no lane); the emission terms are left out, since the scene holds
no emitter and the program adds zeros there; no stats are counted.

``lowp=True`` is the control: every radiance quantity rounded to bfloat16,
as :class:`benchlib.reference.Reference` rounds it, and the sky's texels
too, before its tables are built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .reference import (
    CPDF,
    EPS_F,
    LANE_BLOCK,
    LIGHT_INF,
    MISS_T,
    Geometry,
    Hit,
    Reference,
    local_to_world,
    make_coord_space,
    norm3,
    offset_origin,
    world_to_local,
)
from .sky_scene import BSDF, LT_AREA, SkyScene

DIFFUSE, MIRROR, MICROFACET, GLASS = BSDF["diffuse"], BSDF["mirror"], BSDF["microfacet"], BSDF["glass"]
COUNT_BLOCK = 2048  # lanes per block of the sky's row counts


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# -- BSDFs (the equations of lens_flare_tpu/integrator/shading.py, one function per family) ---------


def beckmann_d(cos_h, alpha):
    """The Beckmann distribution of half vectors, exp(-tan^2 / alpha^2) / (pi alpha^2 cos^4) (``:137``)."""
    c2 = cos_h * cos_h
    return torch.exp((c2 - 1.0) / (c2 * alpha * alpha)) / (math.pi * alpha * alpha * c2 * c2)


def smith_g1(cos_t, alpha):
    """Walter's rational fit to Beckmann's Smith term, 1 from a = cot / alpha = 1.6 up (``:146-151``)."""
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    a = cos_t / torch.clamp_min(alpha * sin_t, 1e-12)
    fit = a * (3.535 + 2.181 * a) / (1.0 + a * (2.276 + 2.577 * a))
    return torch.where((a < 1.6) & (sin_t != 0.0), fit, 1.0)


def fresnel_conductor(cos_i, eta, k):
    """The conductor's reflectance per channel, the mean of its s and p terms (``:154-161``); cos_i (N,)."""
    c = cos_i[:, None]
    c2 = c * c
    e2k2 = eta * eta + k * k
    two_ec = 2.0 * eta * c
    rs = (e2k2 + c2 - two_ec) / (e2k2 + c2 + two_ec)
    rp = (e2k2 * c2 + 1.0 - two_ec) / (e2k2 * c2 + 1.0 + two_ec)
    return 0.5 * (rs + rp)


def fresnel_schlick(cos_i, ior):
    """Schlick's dielectric reflectance, r0 + (1 - r0)(1 - |cos|)^5 (``:164-167``)."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    m = 1.0 - torch.abs(cos_i)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def microfacet_f(alpha_rows, eta, k, wi, wo):
    """F D G / (4 cos_o cos_i) where both directions lie above the surface, 0 elsewhere (``:126-143``)."""
    h = wi + wo
    h = h / torch.clamp_min(norm3(h), 1e-30)[:, None]
    alpha = torch.clamp_min(alpha_rows, 1e-4)
    D = beckmann_d(torch.clamp(h[:, 2], 1e-6, 1.0), alpha)
    G = smith_g1(torch.abs(wi[:, 2]), alpha) * smith_g1(torch.abs(wo[:, 2]), alpha)
    F = fresnel_conductor(torch.abs(wi[:, 2]), eta, k)
    f = F * (D * G / (4.0 * torch.clamp_min(wi[:, 2] * wo[:, 2], 1e-6)))[:, None]
    return torch.where(((wi[:, 2] > 0) & (wo[:, 2] > 0))[:, None], f, 0.0)


def sample_diffuse(albedo, u):
    """The cosine-weighted hemisphere (``:212-221``): (f, wi, pdf, valid)."""
    r, phi = torch.sqrt(u[:, 0]), 2.0 * math.pi * u[:, 1]
    z = torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    pdf = z / math.pi
    return albedo / math.pi, wi, pdf, pdf > 0


def mirror_dir(wo):
    """The reflection about the local normal, and its |cos| (at least 1e-6)."""
    wi = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
    return wi, torch.clamp_min(torch.abs(wo[:, 2]), 1e-6)


def sample_mirror(reflectance, wo):
    """A perfect mirror, f = R / cos with pdf 1 (``:235-242``)."""
    wi, cos = mirror_dir(wo)
    return reflectance / cos[:, None], wi, torch.ones_like(cos), torch.abs(wo[:, 2]) > 1e-6


def sample_glass(reflectance, transmittance, ior, wo, coin):
    """Schlick's coin between the mirror lobe and Snell's refraction, f = (1 - R) T / (cos eta^2) through
    the glass; total internal reflection always reflects (``:244-282``)."""
    wi_r, cos_r = mirror_dir(wo)
    entering = wo[:, 2] > 0
    eta = torch.where(entering, 1.0 / ior, ior)  # eta_i / eta_t
    sin2_t = eta * eta * torch.clamp_min(1.0 - wo[:, 2] * wo[:, 2], 0.0)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wi_t = torch.stack([-eta * wo[:, 0], -eta * wo[:, 1], torch.where(entering, -cos_t, cos_t)], dim=-1)
    cos_tt = torch.clamp_min(cos_t, 1e-6)
    R = torch.where(sin2_t > 1.0, 1.0, fresnel_schlick(wo[:, 2], ior))
    reflect = coin < R
    f = torch.where(reflect[:, None], R[:, None] * reflectance / cos_r[:, None],
                    (1.0 - R)[:, None] * transmittance / (cos_tt * eta * eta)[:, None])
    pdf = torch.where(reflect, R, 1.0 - R)
    return f, torch.where(reflect[:, None], wi_r, wi_t), pdf, pdf > 0


def sample_microfacet(alpha_rows, eta, k, wo, u):
    """A Beckmann half vector, tan^2 theta_h = -alpha^2 ln(1 - u0), phi_h = 2 pi u1, and wi its reflection
    of wo; pdf D(h) cos_h / (4 wo.h), the half vector's density moved to wi's (``:284-306``)."""
    alpha = torch.clamp_min(alpha_rows, 1e-4)
    tan2 = torch.clamp_min(-alpha * alpha * torch.log(torch.clamp_min(1.0 - u[:, 0], 1e-12)), 0.0)
    cos_h = torch.rsqrt(1.0 + tan2)
    sin_h = torch.sqrt(tan2) * cos_h
    phi = 2.0 * math.pi * u[:, 1]
    h = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h], dim=-1)
    wo_h = dot3(wo, h)
    wi = 2.0 * wo_h[:, None] * h - wo
    pdf = beckmann_d(torch.clamp_min(cos_h, 1e-6), alpha) * cos_h / torch.clamp_min(4.0 * wo_h, 1e-9)
    # at theta_h = 0 exactly (u0 = 0) the spec's density p(theta) / sin_h is 0 (``:302``): no sample
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0) & (pdf > 1e-9) & (tan2 > 0)
    return microfacet_f(alpha_rows, eta, k, wi, wo), wi, pdf, valid


class Materials:
    """The scene's material rows on the device, each family's parameters in its own columns."""

    def __init__(self, materials: list, device):
        n = len(materials)
        cols = {k: np.zeros((n, 3), np.float32) for k in ("reflectance", "transmittance", "eta", "k")}
        cols["albedo"] = np.full((n, 3), 0.5, np.float32)  # the loader's default diffuse row
        cols["alpha"], cols["ior"] = np.zeros(n, np.float32), np.ones(n, np.float32)
        kind = np.zeros(n, np.int64)
        for i, m in enumerate(materials):
            kind[i] = BSDF[m["kind"]]
            for key, v in m.items():
                if key in cols:
                    cols[key][i] = np.asarray(v, np.float64)
        self.kind = torch.as_tensor(kind, device=device)
        for key, v in cols.items():
            setattr(self, key, torch.as_tensor(v, device=device))

    def eval_f(self, b, wi, wo):
        """f(wi, wo) of the non-delta families: diffuse albedo / pi, the microfacet lobe; 0 elsewhere
        (``:104-123``)."""
        t = self.kind[b]
        f = torch.where((t == DIFFUSE)[:, None], self.albedo[b] / math.pi, 0.0)
        f_micro = microfacet_f(self.alpha[b], self.eta[b], self.k[b], wi, wo)
        return torch.where((t == MICROFACET)[:, None], f_micro, f)

    def sample_f(self, b, wo, u):
        """(f, wi, pdf, valid) of one importance sample per lane, each lane's own family; u (N, 3): two
        uniforms for the direction, the third for the glass's coin."""
        t = self.kind[b]
        out = sample_diffuse(self.albedo[b], u)
        for code, lobe in (
            (MIRROR, lambda: sample_mirror(self.reflectance[b], wo)),
            (GLASS, lambda: sample_glass(self.reflectance[b], self.transmittance[b], self.ior[b], wo, u[:, 2])),
            (MICROFACET, lambda: sample_microfacet(self.alpha[b], self.eta[b], self.k[b], wo, u)),
        ):
            m = t == code
            out = tuple(torch.where(m[:, None] if a.dim() > 1 else m, a, o) for a, o in zip(lobe(), out))
        return out


# -- the sky (the equations of lens_flare_tpu/integrator/envlight.py) ------------------------


def theta_phi_to_dir(theta, phi):
    y = torch.cos(theta)
    x = torch.cos(phi - math.pi) * torch.sin(theta)
    z = -torch.sin(phi - math.pi) * torch.sin(theta)
    return torch.stack([x, y, z], dim=-1)


def _round_int(v):
    return torch.nan_to_num(torch.round(v), nan=0.0).clamp(-(2**31), 2**31 - 1).to(torch.int64)


def _take(i, n: int):
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


class Sky:
    """The sky's texels and its sampling tables: luminance x sin(theta), a marginal CDF over rows and a
    conditional CDF within each row, built in float64 and stored as float32."""

    def __init__(self, texels: np.ndarray, device):
        data = np.asarray(texels, np.float64)
        h = data.shape[0]
        lum = 0.2126 * data[..., 0] + 0.7152 * data[..., 1] + 0.0722 * data[..., 2]
        pdf = lum * np.sin(np.pi * (np.arange(h)[:, None] + 0.5) / h)
        pdf /= pdf.sum()
        row_sums = pdf.sum(axis=1, keepdims=True)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.data = f32(data)
        self.pdf_map = f32(pdf)
        self.marginal_y = f32(np.cumsum(pdf.sum(axis=1)))
        self.conds_y = f32(np.cumsum(pdf / np.maximum(row_sums, 1e-300), axis=1))

    def texel(self, u):
        """(y, x) of the texel each lane's uniforms (N, 2) pick: rows and columns counted, not searched."""
        h, w = self.pdf_map.shape
        ys, xs = [], []
        for i in range(0, u.shape[0], COUNT_BLOCK):
            ub = u[i : i + COUNT_BLOCK]
            y = torch.clamp((self.marginal_y[None, :] <= ub[:, 1:2]).sum(dim=1), 0, h - 1)
            x = torch.clamp((self.conds_y[y] <= ub[:, 0:1]).sum(dim=1), 0, w - 1)
            ys.append(y)
            xs.append(x)
        return torch.cat(ys), torch.cat(xs)

    def sample(self, u):
        """(radiance, wi, pdf) of one importance sample per lane."""
        h, w = self.pdf_map.shape
        y, x = self.texel(u)
        theta = y.to(torch.float32) / h * math.pi
        phi = x.to(torch.float32) / w * 2.0 * math.pi
        pdf = self.pdf_map[y, x] * (w * h) / (2.0 * math.pi * math.pi * torch.clamp_min(torch.sin(theta), 1e-6))
        return self.data[y, x], theta_phi_to_dir(theta, phi), pdf

    def lookup(self, d):
        """The radiance a ray of direction d (N, 3) that misses sees: the wrap-around bilerp."""
        d = torch.where(torch.isfinite(d).all(dim=-1, keepdim=True), d, 0.0)
        unit = d / torch.clamp_min(norm3(d), 1e-30)[:, None]
        theta = torch.arccos(torch.clamp(unit[:, 1], -1.0, 1.0))
        phi = torch.arctan2(-unit[:, 2], unit[:, 0]) + math.pi
        h, w = self.pdf_map.shape
        x = phi / (2.0 * math.pi) * w
        y = theta / math.pi * h
        right = _round_int(x)
        v = _round_int(y)
        u1 = right.to(torch.float32) - x + 0.5
        wrap = (right == 0) | (right == w)
        left = torch.where(wrap, w - 1, right - 1)
        right = torch.where(right == w, 0, right)
        v_lo, v_hi = v == 0, v == h
        v1 = torch.where(v_lo | v_hi, 0.0, v.to(torch.float32) - y + 0.5)
        v1 = torch.where(v_lo, 1.0, v1)
        v = torch.where(v_lo, 1, torch.where(v_hi, h - 1, v))
        top, bottom = _take(v - 1, h), _take(v, h)
        left, right = _take(left, w), _take(right, w)
        flat = self.data.reshape(-1, 3)
        c_tl, c_tr = flat[top * w + left], flat[top * w + right]
        c_bl, c_br = flat[bottom * w + left], flat[bottom * w + right]
        u0 = 1.0 - u1
        u1e, u0e, v1e = u1[:, None], u0[:, None], v1[:, None]
        return (c_tl * u1e + c_tr * u0e) * v1e + (c_bl * u1e + c_br * u0e) * (1.0 - v1e)


class SkyReference(Reference):
    """The plain reference of one config-3 scene (``settings``: ``max_ray_depth``, ``indirect`` and the
    render ``seed``)."""

    def __init__(self, scene: SkyScene, settings: dict, device, lowp: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = torch.device(device)
        self.lowp = lowp
        self.geo = Geometry(scene.tri_p, scene.tri_n, self.dev)
        self.tri_bsdf = torch.as_tensor(scene.tri_bsdf, dtype=torch.int64, device=self.dev)
        self.mats = Materials(scene.materials, self.dev)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.dev)

        self.light_types = [int(c) for c in scene.light_type]
        self.light_rad, self.light_pos, self.light_dir = t(scene.light_radiance), t(scene.light_position), \
            t(scene.light_direction)
        self.light_dim_x, self.light_dim_y, self.light_area = t(scene.light_dim_x), t(scene.light_dim_y), \
            t(scene.light_area)
        texels = scene.sky
        if lowp:
            texels = torch.as_tensor(texels).to(torch.bfloat16).to(torch.float32).numpy()
        self.sky = Sky(texels, self.dev)
        self.depth = int(settings["max_ray_depth"])
        self.indirect = bool(settings.get("indirect", True))
        self.seed = int(settings["seed"])
        self.bokeh = None

    @property
    def n_slots(self) -> int:
        return len(self.light_types) + 1  # each scene light is one slot (ns_area_light 1), then the sky

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
        bsdf = torch.where(found, self.tri_bsdf[torch.clamp_min(tid, 0)], 0)
        backface = (n[:, 0] * d[:, 0] + n[:, 1] * d[:, 1] + n[:, 2] * d[:, 2]) > 0
        flip = backface & (self.mats.kind[bsdf] != GLASS) & found
        hit = Hit(t, torch.where(flip[:, None], -n, n), found)
        hit.bsdf = bsdf
        return hit

    def _nee_active(self, hit, alive):
        kind = self.mats.kind[hit.bsdf]
        return alive & ((kind == DIFFUSE) | (kind == MICROFACET))

    # -- the estimator -----------------------------------------------------

    def _light_samples(self, u, hit_p):
        """(radiance, wi, dist, pdf) of each slot, the slots one after another: (S * N, ...)."""
        n_pts = hit_p.shape[0]
        rad, wi, dist, pdf = [], [], [], []
        for row, code in enumerate(self.light_types):
            r = self.light_rad[row].expand(n_pts, 3)
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
            else:  # the sun
                rad.append(r)
                wi.append(self.light_dir[row].expand(n_pts, 3))
                dist.append(torch.full((n_pts,), LIGHT_INF, device=self.dev))
                pdf.append(torch.ones(n_pts, device=self.dev))
        s = len(self.light_types)
        sky_rad, sky_wi, sky_pdf = self.sky.sample(u[:, 2 * s : 2 * s + 2])
        rad.append(sky_rad)
        wi.append(sky_wi)
        dist.append(torch.full((n_pts,), LIGHT_INF, device=self.dev))
        pdf.append(sky_pdf)
        return tuple(torch.cat(x) for x in (rad, wi, dist, pdf))

    def _direct(self, u, hit_p, n, frame, active, bsdf):
        o2w, w_out = frame
        n_pts = hit_p.shape[0]
        n_slots = self.n_slots

        def rep(x):
            return x.repeat((n_slots,) + (1,) * (x.dim() - 1))

        ls_rad, ls_wi, ls_dist, ls_pdf = self._light_samples(u, hit_p)
        wi_obj = world_to_local(rep(o2w), ls_wi)
        live = (wi_obj[:, 2] >= 0) & (ls_pdf > 0) & rep(active)
        cos_theta = wi_obj[:, 2] / torch.clamp_min(norm3(wi_obj), 1e-30)
        f = self.q(self.mats.eval_f(rep(bsdf), wi_obj, rep(w_out)))
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
        L = self._direct(tape[:, 4 : 4 + 2 * s], hit_p, hit.n, (frame0, w_out0), self._nee_active(hit, hit.hit),
                         hit.bsdf)
        if self.indirect and self.depth > 1:
            L = self.q(L + self._indirect(tape[:, 4 + 2 * s :], o, d, hit, (frame0, w_out0)))
        return self.q(torch.where(hit.hit[:, None], L, self.sky.lookup(d)))

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
            nxt_p = hit_p + wi_world * nxt.t[:, None]
            o2w_n = make_coord_space(nxt.n)
            w_out_n = world_to_local(o2w_n, -wi_world)
            Ld = self._direct(u_b[:, 4:], nxt_p, nxt.n, (o2w_n, w_out_n), self._nee_active(nxt, cont), nxt.bsdf)
            L = self.q(L + torch.where(cont[:, None], throughput * Ld, 0.0))
            cur_o, cur_d, cur_hit, o2w, w_out, active = hit_p, wi_world, nxt, o2w_n, w_out_n, cont
        return L

    def first_hits(self, cam, px, py, width: int, height: int):
        """(material row, hit) of each pixel's camera ray at sample 0 (-1 where it sees the sky): which
        of the scene's parts the checked pixels show."""
        out = []
        for i in range(0, px.shape[0], LANE_BLOCK):
            p, q = px[i : i + LANE_BLOCK], py[i : i + LANE_BLOCK]
            base = rng.fold_in(rng.prng_key(self.seed, self.dev).expand(p.shape[0], 2),
                               (q.to(torch.int64) * width + p) & rng.MASK32)
            tape = rng.uniform(rng.fold_in(base, torch.zeros_like(p)), (2,))
            o, d = self._rays(cam, (p.to(torch.float32) + tape[:, 0]) / width,
                              (q.to(torch.float32) + tape[:, 1]) / height, None, None)
            hit = self._closest(o.contiguous(), d.contiguous(), cam["n_clip"].expand(p.shape[0]),
                                cam["f_clip"].expand(p.shape[0]))
            out.append(torch.where(hit.hit, hit.bsdf, -1))
        return torch.cat(out)
