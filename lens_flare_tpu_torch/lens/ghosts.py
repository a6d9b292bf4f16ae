"""Ghost splatting: textured-quad rasterization as batched tensor ops.

Counterpart of ``lens_flare_tpu/lens/ghosts.py`` (``draw_ghost`` ->
``rasterize_textured_triangle`` -> ``fill_textured_pixel``,
``pathtracer.cpp:305-508``):

- :func:`splat_ghosts` is the exact method (the reference's edge functions,
  vertex sort, half-pixel offsets and floor-indexed nearest fetch), used
  for small films;
- ``smooth=True`` is its differentiable variant for lens design
  (:mod:`lens_flare_tpu_torch.diff.optimize`): sigmoid edge weights and a
  bilinear texture fetch, so pixels have useful gradients in the
  prescription; autograd gives the backward;
- :func:`splat_ghosts_fast` resamples one precomputed canonical ghost card
  per ghost with two separable matrix products (bilinear), used from
  2^18 pixels up (1080p).

The subsampled ghost buffer (``splat_ghosts(scale=)``, the JAX renderer's
``flare_ghost_scale``) is not ported: no command-line flag sets it
(ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import torch

_SQRT2 = 2.0**0.5


def _sort3_by_y(vx, vy, vu, vv):
    """3-element compare-swap network on y (rasterize_textured_triangle:350-369)."""
    vx, vy, vu, vv = list(vx), list(vy), list(vu), list(vv)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        swap = vy[b] < vy[a]
        for arr in (vx, vy, vu, vv):
            arr[a], arr[b] = torch.where(swap, arr[b], arr[a]), torch.where(swap, arr[a], arr[b])
    return vx, vy, vu, vv


def _raster_triangle(tex, width, height, vx, vy, vu, vv, color, xs, ys, smooth=False, smooth_eps=0.05):
    """One textured triangle -> (P, 3) additive contribution at pixels (xs, ys).

    Vertex values of shape (G,) instead of () give G triangles at once,
    -> (G, P, 3).  ``smooth=True``: the differentiable variant
    (``ghosts.py:88-109``), a sigmoid of the smallest edge function over
    ``smooth_eps`` in place of the inside test and a bilinear fetch in
    place of the nearest one.
    """
    vx, vy, vu, vv = _sort3_by_y(vx, vy, vu, vv)
    x0, x1, x2 = (v[..., None] - 0.5 for v in vx)  # pixel centers as integer coords
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

    alpha = (-(y1 - y0) * (x - x0) + (x1 - x0) * (y - y0)) / (
        -(y1 - y0) * (x2 - x0) + (x1 - x0) * (y2 - y0)
    )
    beta = (-(y2 - y1) * (x - x1) + (x2 - x1) * (y - y1)) / (
        -(y2 - y1) * (x0 - x1) + (x2 - x1) * (y0 - y1)
    )
    gamma = 1.0 - alpha - beta
    inside = (alpha >= 0) & (beta >= 0) & (gamma >= 0)
    u = u2 * alpha + u0 * beta + u1 * gamma
    v = v2 * alpha + v0 * beta + v1 * gamma

    h_a, w_a = tex.shape
    if smooth:
        soft_inside = torch.sigmoid(torch.minimum(torch.minimum(alpha, beta), gamma) / smooth_eps)
        # NaN from a degenerate triangle: index 0, the weight stays NaN as in JAX
        x0f = torch.clamp(u - 0.5, 0.0, w_a - 1.001)
        y0f = torch.clamp(v - 0.5, 0.0, h_a - 1.001)
        xi = torch.floor(torch.nan_to_num(x0f.detach(), nan=0.0)).to(torch.int64)
        yi = torch.floor(torch.nan_to_num(y0f.detach(), nan=0.0)).to(torch.int64)
        fx = x0f - xi
        fy = y0f - yi
        xj = torch.clamp_max(xi + 1, w_a - 1)
        yj = torch.clamp_max(yi + 1, h_a - 1)
        sample = (
            tex[yi, xi] * (1 - fx) * (1 - fy)
            + tex[yi, xj] * fx * (1 - fy)
            + tex[yj, xi] * (1 - fx) * fy
            + tex[yj, xj] * fx * fy
        )
        weight = torch.where(in_box, sample * soft_inside, 0.0)
        return weight[..., None] * color[..., None, :]

    flat_idx = torch.floor(v) * w_a + u  # pixels[int(floor(v) * w_a + u)]
    # clamp before the cast (same indices as cast-then-clip; NaN from a
    # degenerate triangle, where inside is False, maps to 0)
    flat_idx = torch.clamp(torch.nan_to_num(flat_idx, nan=0.0), 0, h_a * w_a - 1).to(torch.int64)
    sample = tex.reshape(-1)[flat_idx]
    weight = torch.where(in_box & inside, sample, 0.0)
    return weight[..., None] * color[..., None, :]


def ghost_corners(r1, r2, axis_ray, width, height):
    """Quad corners [ul, ll, ur, lr] and intensity of one ghost (draw_ghost:433-498).

    r1, r2 of shape (G,) give G ghosts: corners (G, 4), intensities (G,).
    """
    angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    shift_amt = -(r1 + r2) / 2.0 * 0.4
    scale_amt = torch.abs(r2 - r1) * 0.2
    gb_mid_x = torch.ceil(axis_ray[0] * width)
    gb_mid_y = torch.ceil(axis_ray[1] * height)
    ca, sa = torch.cos(angle), torch.sin(angle)
    # the corners' signs (-1, 1), (-1, -1), (1, 1), (1, -1) times the scale,
    # made on the device (capturable) with the products' values
    sx = torch.stack([-scale_amt, -scale_amt, scale_amt, scale_amt], dim=-1)
    sy = torch.stack([scale_amt, -scale_amt, scale_amt, -scale_amt], dim=-1)
    rx = ca * sx - sa * sy + shift_amt[..., None] * ca
    ry = sa * sx + ca * sy + shift_amt[..., None] * sa
    intensity = 10.0 / torch.clamp_min(scale_amt * scale_amt, 1e-12)
    return gb_mid_x + rx, gb_mid_y + ry, intensity


def _tri1(c):
    """Corners [ul, ll, ur] of (..., 4) corners [ul, ll, ur, lr]: slices, no index tensor from the host."""
    return c[..., :3]


def _tri2(c):
    """Corners [lr, ll, ur]."""
    return torch.cat([c[..., 3:], c[..., 1:3]], dim=-1)


def splat_eval(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth=False):
    """Additive ghost field at pixel coords (P,) -> (P, 3); ``smooth`` as in :func:`_raster_triangle`."""
    h_a, w_a = tex.shape
    dev = tex.device
    eye = torch.eye(3, dtype=tex.dtype, device=dev)  # the uv corners, made on the device
    uv_u = eye[2] * w_a  # (0, 0, w)
    uv_v = eye[1] * h_a  # (0, h, 0)
    buf = torch.zeros((xs.shape[0], 3), dtype=tex.dtype, device=dev)
    if smooth:
        # every ghost at once, (G, P) per triangle, summed over the ghosts
        cx, cy, intensity = ghost_corners(r1s, r2s, axis_ray, width, height)
        col = colors * intensity[:, None]
        t1 = _raster_triangle(tex, width, height, _tri1(cx).T, _tri1(cy).T, uv_u, uv_v, col, xs, ys, True)
        t2 = _raster_triangle(tex, width, height, _tri2(cx).T, _tri2(cy).T, uv_u, uv_v, col, xs, ys, True)
        return buf + (t1 + t2).sum(dim=0)
    for g in range(r1s.shape[0]):
        cx, cy, intensity = ghost_corners(r1s[g], r2s[g], axis_ray, width, height)
        col = colors[g] * intensity
        # triangle 1: (ul, uv 0,0), (ll, uv 0,h), (ur, uv w,0)  [draw_ghost:496]
        t1 = _raster_triangle(tex, width, height, _tri1(cx), _tri1(cy), uv_u, uv_v, col, xs, ys)
        # triangle 2: (lr, uv 0,0), (ll, uv 0,h), (ur, uv w,0)  [draw_ghost:498]
        t2 = _raster_triangle(tex, width, height, _tri2(cx), _tri2(cy), uv_u, uv_v, col, xs, ys)
        buf = buf + t1 + t2
    return buf


def splat_ghosts(tex, r1s, r2s, colors, axis_ray, width, height, smooth=False):
    """Exact ghost buffer (generate_ghost_buffer) -> (H, W, 3); ``smooth``: the differentiable variant."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=tex.device), torch.arange(width, device=tex.device), indexing="ij"
    )
    return splat_eval(
        tex, r1s, r2s, colors, axis_ray, width, height, xs.reshape(-1), ys.reshape(-1), smooth
    ).reshape(height, width, 3)


def canonical_ghost_card(tex, axis_ray, res: int = 1024):
    """Rotated ghost card on a res^2 grid spanning [-sqrt2, sqrt2]^2 quad units.

    Every ghost is this one image (the texture through draw_ghost's
    two-triangle uv map, rotated by the angle to the sun), scaled and
    translated on the film.
    """
    h_a, w_a = tex.shape
    dev = tex.device
    angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(angle), torch.sin(angle)
    ys_, xs_ = torch.meshgrid(
        torch.arange(res, device=dev), torch.arange(res, device=dev), indexing="ij"
    )
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
    """(out_size, res) two-tap linear weights from film pixels to card texels."""
    dev = center.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(res, dtype=torch.float32, device=dev)[None, :]
    src = ((o - center) / s + _SQRT2) * res / (2.0 * _SQRT2) - 0.5
    return torch.clamp_min(1.0 - torch.abs(src - i), 0.0)


def splat_ghosts_fast(tex, r1s, r2s, colors, axis_ray, width, height, card=None, res: int = 1024):
    """Gather-free ghost buffer: Wy @ card @ Wx^T per ghost -> (H, W, 3).

    The products are plain float32 matrix products (TF32 must be off).
    """
    if card is None:
        card = canonical_ghost_card(tex, axis_ray, res)
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
        wy = _linear_taps(height, res, s, gb_mid_y + shift_amt * sa)  # (H, R)
        wx = _linear_taps(width, res, s, gb_mid_x + shift_amt * ca)  # (W, R)
        ghost = wy @ card @ wx.T  # (H, W)
        intensity = 10.0 / torch.clamp_min(s * s, 1e-12)
        buf = buf + ghost[:, :, None] * (colors[g] * intensity)
    return buf
