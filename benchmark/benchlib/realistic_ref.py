"""The plain reference of the config-3 flare: the Snell + Fresnel ghost stack, the starburst and the falloff.

The ghosts follow the equations of ``lens_flare_tpu/lens/realistic.py``
(``trace_ghost_stack``, ``render_ghosts_stack``), written again in plain
PyTorch: for each of the 13 reflection pairs and each wavelength, a
collimated beam from the sun over a 32 x 32 pupil grid (masked to the disc
of the marginal ray) is traced surface by surface through the reference's
9-interface lens (:func:`benchlib.flare_ref._lens`): exact Snell refraction
with the unpolarized dielectric Fresnel transmittance at every interface,
Fresnel reflection at the pair's two surfaces, the iris clipping; each ray
lands on the sensor, is turned into the sun's screen direction, scaled by
0.4 pixels per sensor unit about the sun's pixel and splatted bilinearly
with weight energy x 10 / rays.  The starburst and the falloff are
:mod:`benchlib.flare_ref`'s.  It imports nothing of the program and takes
the benchmark's own light rows, camera and aperture mask.

Departures from the program: each ghost is traced on its own, unrolled over
its own events (the program runs all 39 in lockstep over a padded event
table, which gives the same values); each pixel's taps are summed in
float64 and rounded once (the program sums float32 taps in a fixed order).

``lowp=True`` is the control: the ghost stack's products in TF32 (each
event's positions and directions rounded to TF32's 10-bit mantissa), the
starburst and the falloff in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flare_ref, rng
from .flare_ref import PAIRS, find_sun

PUPIL = 32
SENSOR_SCALE = 0.4
INTENSITY = 10.0


def tf32(x):
    """x rounded to TF32 (a 10-bit mantissa), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _dot(a, b):
    return (a * b).sum(-1)


def _safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def fresnel_dielectric(cos_i, n1, n2):
    """The unpolarized dielectric Fresnel reflectance; total internal reflection gives 1."""
    cos_i = torch.abs(cos_i)
    sin2_t = (n1 / n2) ** 2 * torch.clamp_min(1.0 - cos_i**2, 0.0)
    tir = sin2_t >= 1.0
    cos_t = _safe_sqrt(1.0 - sin2_t)
    rs = ((n1 * cos_i - n2 * cos_t) / torch.clamp_min(n1 * cos_i + n2 * cos_t, 1e-12)) ** 2
    rp = ((n1 * cos_t - n2 * cos_i) / torch.clamp_min(n1 * cos_t + n2 * cos_i, 1e-12)) ** 2
    return torch.where(tir, 1.0, 0.5 * (rs + rp))


def intersect_surface(o, d, z_vertex, c):
    """(t, normal against the ray, valid) of rays o, d (N, 3) at the interface of vertex z and curvature c:
    the sphere of radius 1/c centred on the axis (its root nearest the vertex plane), or the plane."""
    shape = o.shape[:-1]
    z_b = torch.broadcast_to(c * 0.0 + z_vertex, shape)
    planar = torch.broadcast_to(torch.abs(c) < 1e-9, shape)
    dz = d[..., 2]
    t_plane = (z_b - o[..., 2]) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    n_plane = torch.zeros_like(o)
    n_plane[..., 2] = -1.0
    R = 1.0 / torch.where(planar, 1.0, torch.broadcast_to(c, shape))
    zero = torch.zeros_like(z_b)
    center = torch.stack([zero, zero, z_b + R], dim=-1)
    oc = o - center
    b = 2.0 * _dot(oc, d)
    cc = _dot(oc, oc) - R * R
    disc = b * b - 4.0 * cc
    sq = _safe_sqrt(disc)
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    near_first = torch.where(dz > 0, R > 0, R < 0)
    t_sph = torch.where(near_first, t1, t2)
    p = o + d * t_sph[..., None]
    n_sph = (p - center) / R[..., None]
    n_sph = torch.where((_dot(n_sph, d) > 0)[..., None], -n_sph, n_sph)
    t = torch.where(planar, t_plane, t_sph)
    n = torch.where(planar[..., None], n_plane, n_sph)
    n = torch.where((_dot(n, d) > 0)[..., None], -n, n)
    valid = torch.where(planar, torch.abs(dz) > 1e-12, disc >= 0) & (t > 1e-9)
    return t, n, valid


def refract(d, n, eta_ratio):
    cos_i = -_dot(d, n)
    sin2_t = eta_ratio**2 * torch.clamp_min(1.0 - cos_i**2, 0.0)
    tir = sin2_t > 1.0
    cos_t = _safe_sqrt(1.0 - sin2_t)
    d_new = eta_ratio[..., None] * d + (eta_ratio * cos_i - cos_t)[..., None] * n
    d_new = d_new / torch.clamp_min(torch.linalg.vector_norm(d_new, dim=-1, keepdim=True), 1e-12)
    return d_new, ~tir


def trace_pair(lens, o, d, color: int, pair, lowp: bool = False):
    """(sensor xy (N, 2), energy (N,)) of rays o, d through reflection pair (i, j) at wavelength ``color``:
    interfaces 0..j forward (reflecting at j), back to i (reflecting at i), then forward to the sensor."""
    spacings, curvatures, iors, ap_height, _, ap = lens
    n_int = spacings.shape[0]
    zs = torch.cat([torch.zeros_like(spacings[:1]), torch.cumsum(spacings, 0)])
    ior = iors[color]
    i, j = pair
    energy = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    valid = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    events = [("R" if k == j else "T", k, False) for k in range(j + 1)]
    events += [("R" if k == i else "T", k, True) for k in range(j - 1, i - 1, -1)]
    events += [("T", k, False) for k in range(i + 1, n_int)]
    q = tf32 if lowp else (lambda x: x)
    for kind, k, backward in events:
        t, n, ok = intersect_surface(o, d, zs[k], curvatures[k])
        p = q(o + d * t[..., None])
        valid = valid & ok
        if k == ap:  # the iris clips and neither refracts nor reflects
            ok = p[..., 0] ** 2 + p[..., 1] ** 2 <= ap_height**2
            energy = energy * ok.to(energy.dtype)
            valid = valid & ok
            o = p
            continue
        n1, n2 = (1.0 if k == 0 else ior[k - 1]), ior[k]
        if backward:
            n1, n2 = n2, n1
        cos_i = -_dot(d, n)
        refl = fresnel_dielectric(cos_i, n1, n2)
        if kind == "T":
            d, ok_r = refract(d, n, torch.broadcast_to(n1 / n2, cos_i.shape))
            energy = energy * (1.0 - refl)
            valid = valid & ok_r
        else:  # the ghost's bounce
            d = d - 2.0 * _dot(d, n)[..., None] * n
            energy = energy * refl
        d = q(d)
        o = p
    dz = d[..., 2]
    t = (zs[n_int] - o[..., 2]) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    p = o + d * t[..., None]
    valid = valid & (t > 0)
    return p[..., :2], energy * valid.to(energy.dtype)


def ghost_buffer(angle, radiance, axis_ray, width: int, height: int, device, pairs=PAIRS, lowp: bool = False):
    """The (H, W, 3) realistic ghost buffer of a sun at ``angle`` (float32 0-d), ``radiance`` (3,) and
    screen point ``axis_ray`` (2,)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens = flare_ref._lens(device)
    lin = np.linspace(-1.0, 1.0, PUPIL)
    gx, gy = np.meshgrid(lin, lin)
    disc_np = (gx**2 + gy**2 <= 1.0).reshape(-1)
    gx, gy = (torch.as_tensor(a.reshape(-1), dtype=torch.float32, device=device) for a in (gx, gy))
    disc = torch.as_tensor(disc_np, dtype=torch.float32, device=device)
    marginal_r = lens[4]
    d0 = torch.stack([torch.sin(angle), torch.zeros_like(angle), torch.cos(angle)])
    o = torch.stack([gx * marginal_r, gy * marginal_r, torch.full((gx.shape[0],), -1.0, device=device)], dim=-1)
    d = d0.expand(o.shape[0], 3)
    gb_x = torch.ceil(axis_ray[0] * width)
    gb_y = torch.ceil(axis_ray[1] * height)
    screen_angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(screen_angle), torch.sin(screen_angle)
    buf = torch.zeros(height * width * 3, dtype=torch.float64, device=device)
    for pair in pairs:
        for color in range(3):
            xy, energy = trace_pair(lens, o, d, color, pair, lowp)
            xs, ys = xy[:, 0], xy[:, 1]
            fx = torch.clamp(gb_x + (ca * xs - sa * ys) * SENSOR_SCALE, -2.0, width + 1.0)
            fy = torch.clamp(gb_y + (sa * xs + ca * ys) * SENSOR_SCALE, -2.0, height + 1.0)
            w = energy * disc * (INTENSITY / int(disc_np.sum()))
            x0, y0 = torch.floor(fx), torch.floor(fy)
            for dx_o in (0, 1):
                for dy_o in (0, 1):
                    xi = (x0 + dx_o).to(torch.int64)
                    yi = (y0 + dy_o).to(torch.int64)
                    wgt = (1 - torch.abs(fx - (x0 + dx_o))) * (1 - torch.abs(fy - (y0 + dy_o)))
                    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
                    idx = (torch.clamp(yi * width + xi, 0, height * width - 1) * 3 + color)[inb]
                    buf.index_add_(0, idx, (w * wgt)[inb].double())
    return buf.to(torch.float32).reshape(height, width, 3) * radiance


def flare(lights, cam, aperture_mask, width: int, height: int, flare_intensity: float, flare_radius: float,
          seed: int, device, lowp: bool = False, pairs=PAIRS):
    """(ghosts, starburst, falloff), each (H, W, 3), of the scene's lights (``light_type``,
    ``light_position``, ``light_radiance``) under ``cam``; zeros when no sun is on screen."""
    origins, radiances, axis_ray, angle = find_sun(lights, cam)
    zeros = torch.zeros((height, width, 3), device=device)
    if len(origins) == 0:
        return zeros, zeros, zeros

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    q = (lambda x: x.to(torch.bfloat16).to(torch.float32)) if lowp else (lambda x: x)
    ghosts = zeros
    if not (axis_ray == 0).all():
        ghosts = ghost_buffer(t(angle), t(radiances.sum(axis=0)), t(axis_ray), width, height, device, pairs, lowp)
    ap = np.asarray(aperture_mask, np.float32)
    burst = zeros
    if float(ap.sum()) != 0:
        h_a, w_a = ap.shape
        ap_t = t(ap)
        if h_a < w_a:
            ap_t = torch.nn.functional.pad(ap_t, (0, 0, 0, w_a - h_a))
        fft_mag = torch.abs(torch.fft.fft2(ap_t))
        burst = q(flare_ref.starburst(fft_mag, float(ap.sum()), w_a, t(origins[0]), t(radiances.sum(axis=0)),
                                      width, height, flare_intensity, flare_radius))
    glow = q(flare_ref.falloff(t(origins), t(radiances), width, height, rng.prng_key(seed, device=device)))
    return ghosts, burst, glow
