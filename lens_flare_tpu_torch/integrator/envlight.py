"""Equirect environment light: importance sampling and the miss lookup.

Counterpart of ``lens_flare_tpu/integrator/envlight.py``
(``src/scene/environment_light.cpp``): the luminance * sin(theta) pdf
grid, the marginal CDF over rows and the conditional CDF within each row
are built in float64 on the host, as the JAX package builds them, and
stored as float32 tensors bit-equal to its tables.  Sampling inverts them
per lane; the miss lookup is the wrap-around bilerp of
environment_light.cpp:123-140.

Two choices keep the eager version lean and safe on a CUDA device:

- the conditional CDF is searched per lane (a binary search over the flat
  (H*W,) table, one gather per step), where the JAX package counts
  ``conds_y[y] <= u`` over a whole (N, W) row that XLA fuses away; each
  row is non-decreasing, so both give the same count;
- every texel index is brought into the table as JAX's indexing does (a
  negative index counts from the end, then the gather clamps), where a
  CUDA gather would abort; texels are gathered through ``embedding`` over
  the flat (H*W, 3) map, so the backward of a texel gradient is a
  segmented sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .shading import norm3, rows

INF = 1e30


class EnvLightArrays(NamedTuple):
    data: torch.Tensor  # (H, W, 3) radiance
    pdf_map: torch.Tensor  # (H, W) normalized pdf
    marginal_y: torch.Tensor  # (H,) inclusive CDF over rows
    conds_y: torch.Tensor  # (H, W) inclusive CDF within each row


class EnvSample(NamedTuple):
    radiance: torch.Tensor  # (N, 3)
    wi: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,)


def build_env(envmap: np.ndarray, device="cpu") -> EnvLightArrays:
    """CDF construction (environment_light.cpp:18-67) in float64 on the host, stored as float32."""
    data = np.asarray(envmap, np.float64)
    h, _w = data.shape[:2]
    lum = 0.2126 * data[..., 0] + 0.7152 * data[..., 1] + 0.0722 * data[..., 2]
    j = np.arange(h)
    pdf = lum * np.sin(np.pi * (j[:, None] + 0.5) / h)
    pdf /= pdf.sum()
    marginal_y = np.cumsum(pdf.sum(axis=1))
    row_sums = pdf.sum(axis=1, keepdims=True)
    conds_y = np.cumsum(pdf / np.maximum(row_sums, 1e-300), axis=1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return EnvLightArrays(data=f32(data), pdf_map=f32(pdf), marginal_y=f32(marginal_y), conds_y=f32(conds_y))


def save_probability_debug(env: EnvLightArrays, path="probability_debug.png") -> None:
    """CDF debug image (environment_light.cpp:71-86): R = marginal, G = conditional."""
    from ..utils.image import save_png

    h, w = env.pdf_map.shape
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = env.marginal_y.detach().cpu().numpy()[:, None]
    img[..., 1] = env.conds_y.detach().cpu().numpy()
    save_png(path, np.clip(img, 0, 1))


def _row_count_le(conds_y: torch.Tensor, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sum(conds_y[y] <= u)`` per lane, without the (N, W) rows.

    Row ``y`` is non-decreasing, so the count is the largest k with
    ``conds_y[y, k - 1] <= u``, found by a branch-free binary search over
    the power-of-two steps of W: one gather per step.
    """
    w = conds_y.shape[1]
    flat = conds_y.reshape(-1)
    base = y * w
    count = torch.zeros_like(y)
    step = 1 << (w.bit_length() - 1)
    while step:
        cand = count + step
        ok = (cand <= w) & (flat[base + torch.clamp(cand - 1, max=w - 1)] <= u)
        count = torch.where(ok, cand, count)
        step >>= 1
    return count


def sample_env(env: EnvLightArrays, u: torch.Tensor) -> EnvSample:
    """Importance sample (environment_light.cpp:143-171); u (N, 2)."""
    h, w = env.pdf_map.shape
    y = torch.searchsorted(env.marginal_y, u[:, 1].contiguous(), right=True)
    y = torch.clamp(y, 0, h - 1)
    x = torch.clamp(_row_count_le(env.conds_y, y, u[:, 0]), 0, w - 1)

    theta = y.to(torch.float32) / h * math.pi
    phi = x.to(torch.float32) / w * 2.0 * math.pi
    wi = theta_phi_to_dir(theta, phi)
    texel = y * w + x
    pdf = (
        env.pdf_map.reshape(-1)[texel]
        * (w * h)
        / (2.0 * math.pi * math.pi * torch.clamp_min(torch.sin(theta), 1e-6))
    )
    return EnvSample(radiance=rows(env.data.reshape(-1, 3), texel), wi=wi, pdf=pdf)


def sample_dir(env: EnvLightArrays, d: torch.Tensor) -> torch.Tensor:
    """Miss-shader radiance lookup (environment_light.cpp:173-182); d (N, 3).

    A direction with a non-finite component is looked up as the zero
    direction (theta = pi/2, phi = pi), so it gets a finite radiance where
    the JAX package returns NaN.
    """
    d = torch.where(torch.isfinite(d).all(dim=-1, keepdim=True), d, 0.0)
    theta, phi = dir_to_theta_phi(d)
    h, w = env.pdf_map.shape
    x = phi / (2.0 * math.pi) * w
    y = theta / math.pi * h
    return bilerp(env.data, x, y)


def dir_to_theta_phi(d: torch.Tensor):
    unit = d / torch.clamp_min(norm3(d), 1e-30)[:, None]
    theta = torch.arccos(torch.clamp(unit[:, 1], -1.0, 1.0))
    phi = torch.arctan2(-unit[:, 2], unit[:, 0]) + math.pi
    return theta, phi


def theta_phi_to_dir(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    y = torch.cos(theta)
    x = torch.cos(phi - math.pi) * torch.sin(theta)
    z = -torch.sin(phi - math.pi) * torch.sin(theta)
    return torch.stack([x, y, z], dim=-1)


def _round_int(v: torch.Tensor) -> torch.Tensor:
    """``round(v).astype(int32)`` as XLA converts it: NaN -> 0, saturated to the int32 range."""
    return torch.nan_to_num(torch.round(v), nan=0.0).clamp(-(2**31), 2**31 - 1).to(torch.int64)


def _take(i: torch.Tensor, n: int) -> torch.Tensor:
    """An index into an axis of n as JAX indexing reads it: negative from the end, then clamped."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def bilerp(data: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Wrap-around bilerp matching environment_light.cpp:123-140; x, y (N,) in texels.

    The weights are the JAX package's, and so are the four taps, also for
    coordinates past the map, which read the texels JAX's indexing reads.
    """
    h, w = data.shape[:2]
    right = _round_int(x)
    v = _round_int(y)
    u1 = right.to(torch.float32) - x + 0.5
    wrap = (right == 0) | (right == w)
    left = torch.where(wrap, w - 1, right - 1)
    right = torch.where(right == w, 0, right)

    v_lo = v == 0
    v_hi = v == h
    # reference: v == 0 -> v = 1, v1 = 1; v == h -> v = h - 1, v1 = 0
    v1 = torch.where(v_lo | v_hi, 0.0, v.to(torch.float32) - y + 0.5)
    v1 = torch.where(v_lo, 1.0, v1)
    v = torch.where(v_lo, 1, torch.where(v_hi, h - 1, v))

    top, bottom = _take(v - 1, h), _take(v, h)
    left, right = _take(left, w), _take(right, w)
    flat = data.reshape(-1, 3)
    c_tl = rows(flat, top * w + left)
    c_tr = rows(flat, top * w + right)
    c_bl = rows(flat, bottom * w + left)
    c_br = rows(flat, bottom * w + right)
    u0 = 1.0 - u1
    u1e, u0e, v1e = u1[:, None], u0[:, None], v1[:, None]
    return (c_tl * u1e + c_tr * u0e) * v1e + (c_bl * u1e + c_br * u0e) * (1.0 - v1e)
