"""The plain reference of the flare: ghosts, starburst and falloff over the whole film.

Frozen plain copies of ``lens_flare_tpu_torch/flare/pipeline.py`` (``find_sun``
and the composite), ``lens/prescription.py`` (the reference lens),
``lens/paraxial.py`` (the 2x2 ghost matrices), ``lens/ghosts.py`` (the
canonical ghost card and its separable resample, used from 2^18 pixels up,
and the exact rasterizer below that),
and ``flare/starburst.py`` (the FFT starburst and the jittered falloff), run
on the benchmark's own masks, camera and sun.  ``lowp=True`` is the control:
the ghost card's matrix products in TF32, the precision below the
configuration's float32 with TF32 off, and the starburst and falloff
rounded to bfloat16.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from . import rng
from .scene import LT_DIRECTIONAL, OrbitCamera, Terrain

_SQRT2 = 2.0**0.5
PAIRS = [(i, j) for i in range(5) for j in range(i + 1, 5)] + [(i, j) for i in range(6, 9) for j in range(i + 1, 9)]


def find_sun(terrain: Terrain, cam: OrbitCamera):
    """(origins (F, 2), radiances (F, 3), axis_ray (2,), angle) of the directional lights on screen."""
    origins, radiances, axis_ray, angle = [], [], np.zeros(2), 0.0
    for li in range(len(terrain.light_type)):
        if terrain.light_type[li] != LT_DIRECTIONAL:
            continue
        ns_x, ns_y = cam.analyze_world_coord(terrain.light_position[li])
        if 0 <= ns_x <= 1 and 0 <= ns_y <= 1:
            origins.append([ns_x, ns_y])
            radiances.append(terrain.light_radiance[li])
            angle = math.atan2(ns_y, ns_x)
            axis_ray = np.array([ns_x, ns_y])
    return (np.asarray(origins, np.float32).reshape(-1, 2), np.asarray(radiances, np.float32).reshape(-1, 3),
            axis_ray, angle)


def _lens(device):
    """The reference's 9-interface lens, rounded from float64 to float32."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=device).to(torch.float32)

    spacings = t([7.700, 1.850, 3.520, 1.850, 4.180, 3.000, 1.850, 7.270, 83.91])
    curvatures = t([1 / 30.810, 1 / -89.350, 1 / 580.380, 1 / -80.630, 1 / 28.340, 0.0, 0.0,
                    1 / 32.190, 1 / -52.990, 1 / 81.320])
    iors = t([[1.652, 1.5991, 1, 1.6396, 1, 1, 1.5776, 1.68990, 1],
              [1.652, 1.6113, 1, 1.65, 1, 1, 1.5885, 1.6999, 1],
              [1.652, 1.6164, 1, 1.6542, 1, 1, 1.5930, 1.7040, 1]])
    return spacings, curvatures, iors, t(11.6), t(14.5), 5


def _m(a00, a01, a10, a11):
    return torch.stack([torch.stack([a00, a01], -1), torch.stack([a10, a11], -1)], -2)


def _mm(a, b):
    return _m(
        a[..., 0, 0] * b[..., 0, 0] + a[..., 0, 1] * b[..., 1, 0],
        a[..., 0, 0] * b[..., 0, 1] + a[..., 0, 1] * b[..., 1, 1],
        a[..., 1, 0] * b[..., 0, 0] + a[..., 1, 1] * b[..., 1, 0],
        a[..., 1, 0] * b[..., 0, 1] + a[..., 1, 1] * b[..., 1, 1],
    )


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = _m(m[..., 1, 1], -m[..., 0, 1], -m[..., 1, 0], m[..., 0, 0])
    return inv / det[..., None, None]


def ghost_heights(theta, device):
    """Sensor heights (r1, r2), each (13, 3), of the +/- marginal rays of every ghost pair."""
    spacings, curv, iors, h, marginal_r, ap = _lens(device)
    n = spacings.shape[0]
    zeros, ones = torch.zeros_like(spacings), torch.ones_like(spacings)
    T = _m(ones, spacings, zeros, ones)
    c = curv[:n]
    n_prev = torch.cat([torch.ones_like(iors[:, :1]), iors[:, : n - 1]], dim=1)
    R = _m(torch.ones_like(iors), torch.zeros_like(iors), c * (n_prev - iors) / iors, n_prev / iors)
    L = _m(ones, zeros, 2.0 * c, ones)
    pairs = torch.tensor(PAIRS, device=device)
    i, j = pairs[:, 0], pairs[:, 1]
    r_in = torch.stack([marginal_r, -marginal_r])
    theta = torch.as_tensor(theta, dtype=T.dtype, device=device)
    p, s = i.shape[0], r_in.shape[0]
    M = torch.eye(2, dtype=T.dtype, device=device).expand(p, 3, 2, 2)
    ray = torch.stack([r_in, theta.expand(s)], dim=-1).expand(p, 3, s, 2)
    r_a = torch.where(r_in < 0, -(h - 0.1), h)

    def fwd_step(k, M, ray, active):
        a = active[:, None, None, None]
        if k == ap:
            a_x = M[..., 0, 0, None] * ray[..., 0] + M[..., 0, 1, None] * ray[..., 1]
            over = torch.abs(a_x) > h
            r_e = (r_a - M[..., 0, 1, None] * ray[..., 1]) / M[..., 0, 0, None]
            ray = torch.where(a & over[..., None], torch.stack([r_e, ray[..., 1]], dim=-1), ray)
            M_new = _mm(T[k], M)
        else:
            M_new = _mm(T[k], _mm(R[:, k], M))
        return torch.where(a, M_new, M), ray

    for k in range(n):
        M, ray = fwd_step(k, M, ray, k < j)
    M = _mm(L[j][:, None], M)
    for k in range(n - 1, 0, -1):
        active = ((k < j) & (k > i))[:, None, None, None]
        M = torch.where(active, _mm(_inv2(R[:, k]), _mm(T[k], M)), M)
    Ti = T[i][:, None]
    M = _mm(Ti, _mm(_inv2(L[i])[:, None], _mm(Ti, M)))
    for k in range(n):
        M, ray = fwd_step(k, M, ray, k > i)
    out = M[..., 0, 0, None] * ray[..., 0] + M[..., 0, 1, None] * ray[..., 1]
    return out[..., 0], out[..., 1]


def ghost_card(tex, axis_ray, res: int = 1024):
    h_a, w_a = tex.shape
    dev = tex.device
    angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(angle), torch.sin(angle)
    ys_, xs_ = torch.meshgrid(torch.arange(res, device=dev), torch.arange(res, device=dev), indexing="ij")
    lx = (xs_ + 0.5) / res * 2 * _SQRT2 - _SQRT2
    ly = (ys_ + 0.5) / res * 2 * _SQRT2 - _SQRT2
    qx = ca * lx + sa * ly
    qy = -sa * lx + ca * ly
    tri1 = qy >= qx
    u = torch.where(tri1, w_a * (qx + 1.0) / 2.0, w_a * (qy + 1.0) / 2.0)
    v = torch.where(tri1, h_a * (1.0 - qy) / 2.0, h_a * (1.0 - qx) / 2.0)
    inside = (torch.abs(qx) <= 1.0) & (torch.abs(qy) <= 1.0)
    flat = torch.clamp(torch.floor(v) * w_a + torch.floor(u), 0, h_a * w_a - 1).to(torch.int64)
    return torch.where(inside, tex.reshape(-1)[flat], 0.0)


def _linear_taps(out_size, res, s, center):
    o = torch.arange(out_size, dtype=torch.float32, device=center.device)[:, None]
    i = torch.arange(res, dtype=torch.float32, device=center.device)[None, :]
    src = ((o - center) / s + _SQRT2) * res / (2.0 * _SQRT2) - 0.5
    return torch.clamp_min(1.0 - torch.abs(src - i), 0.0)


def ghost_buffer(tex, r1s, r2s, colors, axis_ray, width, height):
    """Wy @ card @ Wx^T per ghost -> (H, W, 3)."""
    card = ghost_card(tex, axis_ray)
    res = card.shape[0]
    gb_mid_x = torch.ceil(axis_ray[0] * width)
    gb_mid_y = torch.ceil(axis_ray[1] * height)
    angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(angle), torch.sin(angle)
    buf = torch.zeros((height, width, 3), device=tex.device)
    for g in range(r1s.shape[0]):
        r1, r2 = r1s[g], r2s[g]
        shift_amt = -(r1 + r2) / 2.0 * 0.4
        s = torch.clamp_min(torch.abs(r2 - r1) * 0.2, 1e-6)
        wy = _linear_taps(height, res, s, gb_mid_y + shift_amt * sa)
        wx = _linear_taps(width, res, s, gb_mid_x + shift_amt * ca)
        ghost = wy @ card @ wx.T
        intensity = 10.0 / torch.clamp_min(s * s, 1e-12)
        buf = buf + ghost[:, :, None] * (colors[g] * intensity)
    return buf


def _sort3_by_y(vx, vy, vu, vv):
    vx, vy, vu, vv = list(vx), list(vy), list(vu), list(vv)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        swap = vy[b] < vy[a]
        for arr in (vx, vy, vu, vv):
            arr[a], arr[b] = torch.where(swap, arr[b], arr[a]), torch.where(swap, arr[a], arr[b])
    return vx, vy, vu, vv


def _raster_triangle(tex, width, height, vx, vy, vu, vv, color, xs, ys):
    """One textured triangle's additive (P, 3) contribution at pixels (xs, ys): edge functions,
    half-pixel offsets, floor-indexed nearest fetch."""
    vx, vy, vu, vv = _sort3_by_y(vx, vy, vu, vv)
    x0, x1, x2 = (v[..., None] - 0.5 for v in vx)
    y0, y1, y2 = (v[..., None] - 0.5 for v in vy)
    u0, u1, u2 = (v[..., None] for v in vu)
    v0, v1, v2 = (v[..., None] for v in vv)
    min_x = torch.clamp_min(torch.floor(torch.minimum(torch.minimum(x0, x1), x2)), 0.0)
    max_x = torch.clamp_max(torch.ceil(torch.maximum(torch.maximum(x0, x1), x2)), width - 1.0)
    min_y = torch.clamp_min(torch.floor(y0), 0.0)
    max_y = torch.clamp_max(torch.ceil(y2), height - 1.0)
    x = xs.to(x0.dtype)
    y = ys.to(y0.dtype)
    in_box = (x >= min_x) & (x < max_x) & (y >= min_y) & (y < max_y)
    alpha = (-(y1 - y0) * (x - x0) + (x1 - x0) * (y - y0)) / (-(y1 - y0) * (x2 - x0) + (x1 - x0) * (y2 - y0))
    beta = (-(y2 - y1) * (x - x1) + (x2 - x1) * (y - y1)) / (-(y2 - y1) * (x0 - x1) + (x2 - x1) * (y0 - y1))
    gamma = 1.0 - alpha - beta
    inside = (alpha >= 0) & (beta >= 0) & (gamma >= 0)
    u = u2 * alpha + u0 * beta + u1 * gamma
    v = v2 * alpha + v0 * beta + v1 * gamma
    h_a, w_a = tex.shape
    flat_idx = torch.floor(v) * w_a + u
    flat_idx = torch.clamp(torch.nan_to_num(flat_idx, nan=0.0), 0, h_a * w_a - 1).to(torch.int64)
    weight = torch.where(in_box & inside, tex.reshape(-1)[flat_idx], 0.0)
    return weight[..., None] * color[..., None, :]


def ghost_buffer_exact(tex, r1s, r2s, colors, axis_ray, width, height):
    """The exact rasterizer the program takes below 2^18 pixels -> (H, W, 3)."""
    h_a, w_a = tex.shape
    dev = tex.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    eye = torch.eye(3, dtype=tex.dtype, device=dev)
    uv_u, uv_v = eye[2] * w_a, eye[1] * h_a
    buf = torch.zeros((xs.shape[0], 3), dtype=tex.dtype, device=dev)
    angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(angle), torch.sin(angle)
    gb_mid_x = torch.ceil(axis_ray[0] * width)
    gb_mid_y = torch.ceil(axis_ray[1] * height)
    for g in range(r1s.shape[0]):
        shift_amt = -(r1s[g] + r2s[g]) / 2.0 * 0.4
        scale_amt = torch.abs(r2s[g] - r1s[g]) * 0.2
        sx = torch.stack([-scale_amt, -scale_amt, scale_amt, scale_amt], dim=-1)
        sy = torch.stack([scale_amt, -scale_amt, scale_amt, -scale_amt], dim=-1)
        cx = gb_mid_x + (ca * sx - sa * sy + shift_amt[..., None] * ca)
        cy = gb_mid_y + (sa * sx + ca * sy + shift_amt[..., None] * sa)
        col = colors[g] * (10.0 / torch.clamp_min(scale_amt * scale_amt, 1e-12))
        t1 = _raster_triangle(tex, width, height, cx[..., :3], cy[..., :3], uv_u, uv_v, col, xs, ys)
        c2x = torch.cat([cx[..., 3:], cx[..., 1:3]], dim=-1)
        c2y = torch.cat([cy[..., 3:], cy[..., 1:3]], dim=-1)
        t2 = _raster_triangle(tex, width, height, c2x, c2y, uv_u, uv_v, col, xs, ys)
        buf = buf + t1 + t2
    return buf.reshape(height, width, 3)


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def starburst(fft_mag, total_value, ap_width, origin, radiance, width, height, flare_intensity, flare_radius):
    dev = fft_mag.device
    a = ap_width
    lr = torch.ceil(origin[0] * width)
    ud = torch.ceil(origin[1] * height)
    lr_i, ud_i = int(lr), int(ud)
    xs = torch.arange(width, device=dev)
    ys = torch.arange(height, device=dev)
    cx = (width + 1) // 2
    cy = height // 2 + 1
    dx = xs - lr_i + width * (xs < cx).to(xs.dtype)
    dy = ud_i - ys + height * (ys >= cy).to(ys.dtype)
    mag = fft_mag.index_select(0, torch.remainder(dy, a)).index_select(1, torch.remainder(dx, a)) / total_value
    x = xs[None, :].to(torch.float32)
    y = ys[:, None].to(torch.float32)
    dist = torch.sqrt((lr - x) ** 2 + (ud - y) ** 2)
    half_ap = ap_width / 2.0
    far_sel = dist > half_ap
    safe_dist = torch.where(far_sel, torch.clamp_min(dist, 1e-6), 1.0)
    mag_far = _pow8(half_ap / safe_dist) * mag
    near_sel = ~far_sel & (dist <= flare_radius) & (flare_radius > 0)
    safe_mag = torch.where(near_sel, torch.clamp_min(mag, 1e-20), 1.0)
    mag_near = safe_mag ** (dist / max(flare_radius, 1e-12))
    mag = torch.where(far_sel, mag_far, torch.where(near_sel, mag_near, mag))
    intensity = 3.0 - flare_intensity
    if intensity <= 0:
        intensity = 2.0
    return (torch.clamp_min(mag, 0.0) ** intensity)[..., None] * radiance


def falloff(origins, radiances, width, height, key, radius: float = 5.0, num_samples: int = 16):
    dev = origins.device
    x = torch.arange(width, device=dev)[None, :]
    y = torch.arange(height, device=dev)[:, None]
    fo_s = origins * torch.tensor([width, height], dtype=torch.float32, device=dev)
    jit = rng.uniform(rng.split(key, num_samples), (2,))
    total = torch.zeros((height, width, 3), device=dev)
    for j in range(num_samples):
        sx = x + jit[j, 0]
        sy = y + jit[j, 1]
        acc = torch.zeros((height, width, 3), device=dev)
        for f in range(fo_s.shape[0]):
            d = torch.sqrt((fo_s[f, 0] - sx) ** 2 + (fo_s[f, 1] - sy) ** 2)
            r = 1.0 + torch.clamp_min(d - radius, 0.0)
            acc = acc + (r**-1.5)[..., None] * radiances[f]
        total = total + acc
    return total / num_samples


@contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def flare(terrain: Terrain, cam: OrbitCamera, ghost_mask, aperture_mask, width: int, height: int,
          flare_intensity: float, flare_radius: float, seed: int, device, lowp: bool = False):
    """The (H, W, 3) flare the composite adds to the film: ghosts + starburst + falloff, each in
    the composite's order; zeros when the sun is off screen."""
    origins, radiances, axis_ray, angle = find_sun(terrain, cam)
    zeros = torch.zeros((height, width, 3), device=device)
    if len(origins) == 0:
        return zeros, zeros, zeros

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    q = (lambda x: x.to(torch.bfloat16).to(torch.float32)) if lowp else (lambda x: x)
    ghosts = zeros
    if not (axis_ray == 0).all() and float(np.asarray(ghost_mask, np.float32).sum()) != 0:
        r1, r2 = ghost_heights(t(angle), device)
        colors = torch.eye(3, device=device).repeat(r1.shape[0], 1)
        splat = ghost_buffer if width * height >= (1 << 18) else ghost_buffer_exact
        with _tf32(lowp):
            ghosts = splat(t(ghost_mask), r1.reshape(-1), r2.reshape(-1), colors, t(axis_ray), width, height)
    ap = np.asarray(aperture_mask, np.float32)
    burst = zeros
    total_value = float(ap.sum())
    if total_value != 0:
        h_a, w_a = ap.shape
        ap_t = t(ap)
        if h_a < w_a:
            ap_t = torch.nn.functional.pad(ap_t, (0, 0, 0, w_a - h_a))
        fft_mag = torch.abs(torch.fft.fft2(ap_t))
        burst = q(starburst(fft_mag, total_value, w_a, t(origins[0]), t(radiances.sum(axis=0)),
                            width, height, flare_intensity, flare_radius))
    glow = q(falloff(t(origins), t(radiances), width, height, rng.prng_key(seed, device=device)))
    return ghosts, burst, glow
