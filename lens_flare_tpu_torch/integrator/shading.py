"""BSDF tables, shading frames, evaluation and sampling of every BSDF family.

Counterpart of ``lens_flare_tpu/integrator/shading.py``: the six families
of the reference (``bsdf.h:119-288``) - diffuse, emission, mirror,
microfacet (Beckmann NDF, Smith shadowing, conductor Fresnel), refraction
and glass (Schlick Fresnel) - evaluated for every lane and selected by
``bsdf_type`` masks.  ``families`` (the BSDF codes a scene's table holds,
``RenderSettings.bsdf_families``) leaves out the families no lane can hit,
as the JAX package specializes them away.  Conventions are the reference's:
directions in the local frame have +z along the normal, ``eval_f`` takes wi
negated (pointing into the surface), ``sample_f`` returns wi pointing away
from it.  Material rows are gathered by index (the JAX package's one-hot
``ops/lookup.py`` products give the same rows), through :func:`rows`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.collada import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    BSDF_GLASS,
    BSDF_MICROFACET,
    BSDF_MIRROR,
    BSDF_REFRACTION,
)


class BSDFArrays(NamedTuple):
    bsdf_type: torch.Tensor  # (B,) int32
    albedo: torch.Tensor  # (B, 3) diffuse reflectance
    radiance: torch.Tensor  # (B, 3) emission
    reflectance: torch.Tensor  # (B, 3) mirror/glass
    transmittance: torch.Tensor  # (B, 3) refraction/glass
    eta: torch.Tensor  # (B, 3) microfacet conductor eta
    k: torch.Tensor  # (B, 3) microfacet conductor k
    alpha: torch.Tensor  # (B,) microfacet roughness
    roughness: torch.Tensor  # (B,)
    ior: torch.Tensor  # (B,) refraction/glass


def bsdf_to_device(table, device) -> BSDFArrays:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return BSDFArrays(
        bsdf_type=torch.as_tensor(np.asarray(table.bsdf_type, np.int32), device=device),
        albedo=f32(table.albedo),
        radiance=f32(table.radiance),
        reflectance=f32(table.reflectance),
        transmittance=f32(table.transmittance),
        eta=f32(table.eta),
        k=f32(table.k),
        alpha=f32(table.alpha),
        roughness=f32(table.roughness),
        ior=f32(table.ior),
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def make_coord_space(n: torch.Tensor) -> torch.Tensor:
    """Normal frame (bsdf.cpp:21-41): n (N, 3) -> o2w (N, 3, 3), columns x, y, z."""
    smallest = torch.argmin(torch.abs(n), dim=-1)
    h = torch.where(torch.arange(3, device=n.device) == smallest[:, None], 1.0, n)
    z = n / torch.clamp_min(norm3(n), 1e-30)[:, None]
    y = cross(h, z)
    y = y / torch.clamp_min(norm3(y), 1e-30)[:, None]
    x = cross(z, y)
    x = x / torch.clamp_min(norm3(x), 1e-30)[:, None]
    return torch.stack([x, y, z], dim=-1)


def world_to_local(o2w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """o2w^T @ v per lane: (N, 3, 3), (N, 3) -> (N, 3)."""
    return torch.stack(
        [o2w[:, 0, j] * v[:, 0] + o2w[:, 1, j] * v[:, 1] + o2w[:, 2, j] * v[:, 2] for j in range(3)],
        dim=-1,
    )


def local_to_world(o2w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """o2w @ v per lane."""
    return torch.stack(
        [o2w[:, i, 0] * v[:, 0] + o2w[:, i, 1] * v[:, 1] + o2w[:, i, 2] * v[:, 2] for i in range(3)],
        dim=-1,
    )


def rows(table: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``table[b]`` for a material table (B, C) or (B,) and int64 lane indices (N,).

    The same rows.  The backward, a material parameter's gradient, sums
    each row's lanes with ``embedding``'s segmented reduction; ``table[b]``'s
    backward on CUDA accumulates the lanes that share a row one after
    another, and a scene's few rows are shared by every lane.
    """
    if table.dim() == 1:
        return torch.nn.functional.embedding(b, table[:, None])[:, 0]
    return torch.nn.functional.embedding(b, table)


def get_emission(bsdfs: BSDFArrays, b: torch.Tensor) -> torch.Tensor:
    """Radiance for emission BSDFs, 0 otherwise."""
    b = b.long()
    is_em = (bsdfs.bsdf_type[b] == BSDF_EMISSION)[:, None]
    return torch.where(is_em, rows(bsdfs.radiance, b), 0.0)


def is_delta(bsdfs: BSDFArrays, b: torch.Tensor) -> torch.Tensor:
    """Delta lobes: mirror, refraction and glass."""
    t = bsdfs.bsdf_type[b.long()]
    return (t == BSDF_MIRROR) | (t == BSDF_REFRACTION) | (t == BSDF_GLASS)


def _has(families, code) -> bool:
    return families is None or code in families


def eval_f(bsdfs: BSDFArrays, b: torch.Tensor, wi_neg: torch.Tensor, wo: torch.Tensor, families=None) -> torch.Tensor:
    """BSDF::f(-wi, wo) -> (N, 3).

    Diffuse albedo / pi (bsdf.cpp:52-61), the microfacet lobe, and 0 for
    emitters and the delta families.
    """
    b = b.long()
    wi = -wi_neg
    t = bsdfs.bsdf_type[b]
    f = torch.where((t == BSDF_DIFFUSE)[:, None], rows(bsdfs.albedo, b) / math.pi, 0.0)
    if _has(families, BSDF_MICROFACET):
        f_micro = _microfacet_f(rows(bsdfs.alpha, b), rows(bsdfs.eta, b), rows(bsdfs.k, b), wi, wo)
        f = torch.where((t == BSDF_MICROFACET)[:, None], f_micro, f)
    return f


def _microfacet_f(alpha_rows, eta, k, wi, wo):
    """Beckmann NDF x Smith shadowing x conductor Fresnel (``shading.py:119-136``)."""
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    h = wi + wo
    h = h / torch.clamp_min(norm3(h), 1e-30)[:, None]
    alpha = torch.clamp_min(alpha_rows, 1e-4)
    cos_h = torch.clamp(h[:, 2], 1e-6, 1.0)
    tan2 = (1.0 - cos_h * cos_h) / (cos_h * cos_h)
    D = torch.exp(-tan2 / (alpha * alpha)) / (math.pi * alpha * alpha * cos_h**4)
    G = _smith_g1(wi, alpha) * _smith_g1(wo, alpha)
    F = fresnel_conductor(torch.abs(wi[:, 2]), eta, k)
    denom = 4.0 * torch.clamp_min(wo[:, 2] * wi[:, 2], 1e-6)
    f = F * (G * D / denom)[:, None]
    return torch.where(valid[:, None], f, 0.0)


def _smith_g1(w, alpha):
    cos_t = torch.abs(w[:, 2])
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    a = cos_t / torch.clamp_min(alpha * sin_t, 1e-12)
    g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where((a >= 1.6) | (sin_t == 0.0), 1.0, g)


def fresnel_conductor(cos_i, eta, k):
    """Per-channel conductor Fresnel (CS184 approximation): cos_i (N,), eta/k (N, 3)."""
    c = cos_i[:, None]
    c2 = c * c
    e2k2 = eta * eta + k * k
    rs = (e2k2 - 2 * eta * c + c2) / (e2k2 + 2 * eta * c + c2)
    rp = (e2k2 * c2 - 2 * eta * c + 1) / (e2k2 * c2 + 2 * eta * c + 1)
    return (rs + rp) / 2


def fresnel_schlick(cos_i, ior):
    """Schlick dielectric reflectance (the glass BSDF's coin)."""
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - torch.abs(cos_i)) ** 5


class BSDFSample(NamedTuple):
    f: torch.Tensor  # (N, 3)
    wi: torch.Tensor  # (N, 3) local frame, away from the surface
    pdf: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


def sample_f(bsdfs: BSDFArrays, b: torch.Tensor, wo: torch.Tensor, u: torch.Tensor, families=None) -> BSDFSample:
    """One importance sample per lane (``shading.py:178-316``); u (N, 3) uniforms.

    u[:, 0:2] drive the direction, u[:, 2] glass's reflect/refract coin.
    Diffuse (and emitters, with f = 0) sample the cosine-weighted
    hemisphere (sampler.cpp:58-68); mirror reflects with f = R / cos;
    refraction bends by Snell (no sample under total internal reflection);
    glass picks reflection with the Schlick probability; microfacet samples
    the Beckmann half vector.
    """
    b = b.long()
    t = bsdfs.bsdf_type[b]
    n = wo.shape[0]
    ones = torch.ones(n, device=wo.device)

    xi1, xi2 = u[:, 0], u[:, 1]
    r = torch.sqrt(xi1)
    phi = 2.0 * math.pi * xi2
    z_cos = torch.sqrt(torch.clamp_min(1.0 - xi1, 0.0))
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z_cos], dim=-1)
    pdf = z_cos / math.pi
    f = rows(bsdfs.albedo, b) / math.pi
    valid = pdf > 0

    def sel(code, vec_f, vec_wi, vec_pdf, vec_valid):
        m = t == code
        return (
            torch.where(m[:, None], vec_f, f),
            torch.where(m[:, None], vec_wi, wi),
            torch.where(m, vec_pdf, pdf),
            torch.where(m, vec_valid, valid),
        )

    if _has(families, BSDF_MIRROR) or _has(families, BSDF_GLASS):
        reflectance = rows(bsdfs.reflectance, b)
        wi_mirr = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
        cos_mirr = torch.clamp_min(torch.abs(wi_mirr[:, 2]), 1e-6)
    if _has(families, BSDF_MIRROR):
        f_mirr = reflectance / cos_mirr[:, None]
        f, wi, pdf, valid = sel(BSDF_MIRROR, f_mirr, wi_mirr, ones, torch.abs(wo[:, 2]) > 1e-6)

    if _has(families, BSDF_REFRACTION) or _has(families, BSDF_GLASS):
        transmittance = rows(bsdfs.transmittance, b)
        ior = rows(bsdfs.ior, b)
        entering = wo[:, 2] > 0
        eta_ratio = torch.where(entering, 1.0 / ior, ior)  # eta_i / eta_t
        sin2_t = eta_ratio**2 * torch.clamp_min(1.0 - wo[:, 2] ** 2, 0.0)
        tir = sin2_t > 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        wi_refr = torch.stack(
            [-eta_ratio * wo[:, 0], -eta_ratio * wo[:, 1], torch.where(entering, -cos_t, cos_t)], dim=-1
        )
        cos_refr = torch.clamp_min(torch.abs(wi_refr[:, 2]), 1e-6)
        f_refr = transmittance / cos_refr[:, None] / (eta_ratio**2)[:, None]
    if _has(families, BSDF_REFRACTION):
        f, wi, pdf, valid = sel(BSDF_REFRACTION, f_refr, wi_refr, ones, ~tir)

    if _has(families, BSDF_GLASS):
        R = fresnel_schlick(wo[:, 2], rows(bsdfs.ior, b))
        R_eff = torch.where(tir, 1.0, R)
        choose_reflect = u[:, 2] < R_eff
        f_glass_reflect = R_eff[:, None] * reflectance / cos_mirr[:, None]
        f_glass_refract = (1.0 - R_eff)[:, None] * transmittance / cos_refr[:, None] / (eta_ratio**2)[:, None]
        wi_glass = torch.where(choose_reflect[:, None], wi_mirr, wi_refr)
        f_glass = torch.where(choose_reflect[:, None], f_glass_reflect, f_glass_refract)
        pdf_glass = torch.where(choose_reflect, R_eff, 1.0 - R_eff)
        f, wi, pdf, valid = sel(BSDF_GLASS, f_glass, wi_glass, pdf_glass, pdf_glass > 0)

    if _has(families, BSDF_MICROFACET):
        alpha = torch.clamp_min(rows(bsdfs.alpha, b), 1e-4)
        theta_h = torch.arctan(
            torch.sqrt(torch.clamp_min(-(alpha**2) * torch.log(torch.clamp_min(1.0 - xi1, 1e-12)), 0.0))
        )
        phi_h = 2.0 * math.pi * xi2
        sin_h, cos_h = torch.sin(theta_h), torch.cos(theta_h)
        h = torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h), cos_h], dim=-1)
        wo_dot_h = dot3(wo, h)
        wi_mf = 2.0 * wo_dot_h[:, None] * h - wo
        # p(theta) = 2 sin / (alpha^2 cos^3) e^{-tan^2/alpha^2}; p(phi) = 1/2pi
        tan2_h = (sin_h / torch.clamp_min(cos_h, 1e-6)) ** 2
        p_theta = (2.0 * sin_h / (alpha**2 * torch.clamp_min(cos_h, 1e-6) ** 3)) * torch.exp(-tan2_h / alpha**2)
        p_phi = 1.0 / (2.0 * math.pi)
        pdf_h = p_theta * p_phi / torch.clamp_min(sin_h, 1e-9)
        pdf_mf = pdf_h / torch.clamp_min(4.0 * wo_dot_h, 1e-9)
        valid_mf = (wi_mf[:, 2] > 0) & (wo[:, 2] > 0) & (pdf_mf > 1e-9)
        f_mf = _microfacet_f(rows(bsdfs.alpha, b), rows(bsdfs.eta, b), rows(bsdfs.k, b), wi_mf, wo)
        f, wi, pdf, valid = sel(BSDF_MICROFACET, f_mf, wi_mf, pdf_mf, valid_mf)

    if _has(families, BSDF_EMISSION):
        f = torch.where((t == BSDF_EMISSION)[:, None], 0.0, f)
    return BSDFSample(f=f, wi=wi, pdf=pdf, valid=valid)
