"""Light tables and light sampling (``src/scene/light.cpp`` semantics).

Counterpart of ``lens_flare_tpu/integrator/lights.py``: ``LightArrays``,
``lights_to_device``, the generic per-lane :func:`sample_light` (``:82``)
and the per-slot :func:`sample_light_static` (``:252``), over the
directional, point, spot, area, hemisphere, sphere and mesh lights, and
the environment light (``LT_ENV``), whose rows sample the map's CDF tables
(:mod:`lens_flare_tpu_torch.integrator.envlight`) at distance ``INF``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.build import (
    LT_AREA,
    LT_DIRECTIONAL,
    LT_HEMISPHERE,
    LT_MESH,
    LT_POINT,
    LT_SPHERE,
    LT_SPOT,
)
from .envlight import INF, sample_env
from .shading import cross, dot3, norm3

LT_ENV = 4


class LightArrays(NamedTuple):
    light_type: torch.Tensor  # (L,) int32
    radiance: torch.Tensor  # (L, 3)
    position: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3) directional: dirToLight; area/spot: facing direction
    dim_x: torch.Tensor  # (L, 3) area: x edge; spot: (cos cone, exponent, 0); sphere: (radius, 0, 0)
    dim_y: torch.Tensor  # (L, 3)
    area: torch.Tensor  # (L,)
    is_delta: torch.Tensor  # (L,) bool
    # mesh-light triangle pool (M >= 1, padded): [p0 | e1 | e2] rows, the
    # owning light row, the in-light cumulative area fraction
    mesh_tri: torch.Tensor
    mesh_tri_light: torch.Tensor
    mesh_tri_cdf: torch.Tensor


class LightSample(NamedTuple):
    radiance: torch.Tensor  # (N, 3)
    wi: torch.Tensor  # (N, 3) world, towards the light
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,)


def _need_env(env) -> None:
    if env is None:
        raise ValueError("an LT_ENV light row samples the environment map: pass its EnvLightArrays as env=")


def lights_to_device(table, device) -> LightArrays:
    def f32(a, shape=None):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(a if shape is None else a.reshape(shape), device=device)

    if len(getattr(table, "mesh_tri", ())):
        mesh_tri = f32(table.mesh_tri, (-1, 9))
        mesh_light = torch.as_tensor(np.asarray(table.mesh_tri_light, np.int32), device=device)
        mesh_cdf = f32(table.mesh_tri_cdf)
    else:  # a padded sentinel row keeps the gathers in bounds
        mesh_tri = torch.zeros((1, 9), device=device)
        mesh_light = torch.full((1,), -1, dtype=torch.int32, device=device)
        mesh_cdf = torch.ones(1, device=device)
    return LightArrays(
        light_type=torch.as_tensor(np.asarray(table.light_type, np.int32), device=device),
        radiance=f32(table.radiance, (-1, 3)),
        position=f32(table.position, (-1, 3)),
        direction=f32(table.direction, (-1, 3)),
        dim_x=f32(table.dim_x, (-1, 3)),
        dim_y=f32(table.dim_y, (-1, 3)),
        area=f32(table.area),
        is_delta=torch.as_tensor(np.asarray(table.is_delta, bool), device=device),
        mesh_tri=mesh_tri,
        mesh_tri_light=mesh_light,
        mesh_tri_cdf=mesh_cdf,
    )


def _unit(v):
    dist = norm3(v)
    return v / torch.clamp_min(dist, 1e-30)[:, None], dist


def _spot_scale(wi, direction, cone):
    """Smooth cone falloff of the spot light (light.cpp:63-71): cone (N, 3) = (cos cone, exponent, 0)."""
    cos_cone, fall_exp = cone[:, 0], cone[:, 1]
    cos_dir = dot3(-wi, direction)
    base = torch.clamp((cos_dir - cos_cone) / torch.clamp_min(1.0 - cos_cone, 1e-6), 0.0, 1.0)
    return base ** torch.clamp_min(fall_exp, 1e-6)


def _area(position, dim_x, dim_y, direction, area, rad, p, u):
    """Area light (light.cpp:76-94) -> (radiance, wi, dist, pdf)."""
    uv = u - 0.5
    d = position + uv[:, 0:1] * dim_x + uv[:, 1:2] * dim_y - p
    cos_theta = dot3(d, direction)
    sq_dist = dot3(d, d)
    dist = torch.sqrt(sq_dist)
    wi = d / torch.clamp_min(dist, 1e-30)[:, None]
    pdf = sq_dist / torch.clamp_min(area * torch.abs(cos_theta), 1e-30)
    return torch.where((cos_theta < 0)[:, None], rad, 0.0), wi, dist, pdf


def _hemisphere(u):
    """Uniform hemisphere about +y world (light.cpp:36-43) -> wi."""
    phi = 2.0 * math.pi * u[:, 1]
    theta = torch.arccos(torch.clamp(u[:, 0], -1.0, 1.0))
    lx, ly, lz = torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)
    return torch.stack([lx, -lz, ly], dim=-1)  # local @ [[1,0,0],[0,0,-1],[0,1,0]].T


def _sphere(center, radius, p, u):
    """Uniform over the subtended cone (light.cpp:99-109, done right) -> (wi, dist, pdf)."""
    phi = 2.0 * math.pi * u[:, 1]
    axis, dc = _unit(center - p)
    sin2_max = torch.clamp((radius / torch.clamp_min(dc, 1e-30)) ** 2, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
    cos_t = 1.0 - u[:, 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    e_x, e_y = torch.eye(3, device=p.device)[:2]  # made on the device: capturable
    h = torch.where(torch.abs(axis[:, 0:1]) > 0.9, e_y, e_x)
    tx = cross(axis, h)
    tx = tx / torch.clamp_min(norm3(tx), 1e-30)[:, None]
    ty = cross(axis, tx)
    wi = axis * cos_t[:, None] + (tx * torch.cos(phi)[:, None] + ty * torch.sin(phi)[:, None]) * sin_t[:, None]
    pdf = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max), 1e-30)
    disc = torch.clamp_min(radius**2 - (dc * sin_t) ** 2, 0.0)
    dist = torch.clamp_min(dc * cos_t - torch.sqrt(disc), 0.0)
    return wi, dist, pdf


def _mesh(lights: LightArrays, mine, area, p, u):
    """Area-uniform point on a mesh light (light.cpp:111-118, done right) -> (wi, dist, pdf).

    ``mine`` (N or 1, M): the pool triangles of each lane's light.  The
    triangle is the first whose cumulative fraction reaches u0 (argmax's
    first index, none -> 0); u0 is rescaled within it.
    """
    tri_cdf = lights.mesh_tri_cdf
    sel = mine & (tri_cdf[None, :] >= u[:, 0:1])
    tri_idx = torch.argmax(sel.to(torch.uint8), dim=-1)
    row = lights.mesh_tri[tri_idx]
    cdf_hi = tri_cdf[tri_idx]
    prev = mine & (torch.arange(tri_cdf.shape[0], device=p.device)[None, :] < tri_idx[:, None])
    cdf_lo = torch.where(prev, tri_cdf[None, :], 0.0).amax(dim=-1)
    u0r = torch.clamp((u[:, 0] - cdf_lo) / torch.clamp_min(cdf_hi - cdf_lo, 1e-30), 0.0, 1.0)
    su = torch.sqrt(u0r)
    b1c = 1.0 - su
    b2c = u[:, 1] * su
    mp0, me1, me2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    pt = mp0 + b1c[:, None] * me1 + b2c[:, None] * me2
    mn = cross(me1, me2)
    mn = mn / torch.clamp_min(norm3(mn), 1e-30)[:, None]
    d = pt - p
    sq = dot3(d, d)
    dist = torch.sqrt(sq)
    wi = d / torch.clamp_min(dist, 1e-30)[:, None]
    pdf = sq / torch.clamp_min(area * torch.abs(dot3(d, mn)), 1e-30)
    return wi, dist, pdf


def sample_light(lights: LightArrays, li, p, u, env=None, types_present=None) -> LightSample:
    """sample_L for a batch of light rows li (N,) at points p (N, 3) with uniforms u (N, 2).

    Every family present is computed for every lane and selected by the
    row's type; ``types_present`` (the LT_* codes of the table) leaves out
    the others.  ``env``: the EnvLightArrays that rows of type LT_ENV sample.
    """

    def has(code):
        return types_present is None or code in types_present

    if types_present is not None and LT_ENV in types_present:
        _need_env(env)
    li = li.long()
    n = p.shape[0]
    lt = lights.light_type[li]
    rad = lights.radiance[li]
    wi = lights.direction[li]  # directional (light.cpp:19-24)
    dist = torch.full((n,), INF, device=p.device)
    pdf = torch.ones(n, device=p.device)
    out_rad = rad

    if has(LT_POINT) or has(LT_SPOT):  # light.cpp:51-58
        wi_point, dist_point = _unit(lights.position[li] - p)
        is_pt = (lt == LT_POINT) | (lt == LT_SPOT)
        wi = torch.where(is_pt[:, None], wi_point, wi)
        dist = torch.where(is_pt, dist_point, dist)
    if has(LT_AREA):
        rad_a, wi_a, dist_a, pdf_a = _area(
            lights.position[li], lights.dim_x[li], lights.dim_y[li], lights.direction[li],
            lights.area[li], rad, p, u,
        )
        is_area = lt == LT_AREA
        wi = torch.where(is_area[:, None], wi_a, wi)
        dist = torch.where(is_area, dist_a, dist)
        pdf = torch.where(is_area, pdf_a, pdf)
        out_rad = torch.where(is_area[:, None], rad_a, out_rad)
    if has(LT_HEMISPHERE):
        is_hemi = lt == LT_HEMISPHERE
        wi = torch.where(is_hemi[:, None], _hemisphere(u), wi)
        pdf = torch.where(is_hemi, 1.0 / (2.0 * math.pi), pdf)
    if has(LT_SPOT):
        scale = _spot_scale(wi_point, lights.direction[li], lights.dim_x[li])
        out_rad = torch.where((lt == LT_SPOT)[:, None], rad * scale[:, None], out_rad)
    if has(LT_SPHERE):
        wi_s, dist_s, pdf_s = _sphere(lights.position[li], lights.dim_x[li][:, 0], p, u)
        is_sph = lt == LT_SPHERE
        wi = torch.where(is_sph[:, None], wi_s, wi)
        dist = torch.where(is_sph, dist_s, dist)
        pdf = torch.where(is_sph, pdf_s, pdf)
    if has(LT_MESH):
        mine = lights.mesh_tri_light[None, :] == li[:, None]
        wi_m, dist_m, pdf_m = _mesh(lights, mine, lights.area[li], p, u)
        is_mesh = lt == LT_MESH
        wi = torch.where(is_mesh[:, None], wi_m, wi)
        dist = torch.where(is_mesh, dist_m, dist)
        pdf = torch.where(is_mesh, pdf_m, pdf)
    if env is not None and has(LT_ENV):
        es = sample_env(env, u)
        is_env = lt == LT_ENV
        wi = torch.where(is_env[:, None], es.wi, wi)
        pdf = torch.where(is_env, es.pdf, pdf)
        out_rad = torch.where(is_env[:, None], es.radiance, out_rad)
        dist = torch.where(is_env, INF, dist)
    return LightSample(radiance=out_rad, wi=wi, dist=dist, pdf=pdf)


def sample_light_static(lights: LightArrays, row: int, code: int, p: torch.Tensor, u: torch.Tensor, env=None) -> LightSample:
    """sample_L for one host-known light row of type ``code`` at points p (N, 3).

    The same formulas as :func:`sample_light`, on the row's values
    broadcast over the lanes.  Delta lights (directional, point, spot)
    leave u unused; an LT_ENV row samples ``env``.
    """
    n = p.shape[0]
    dev = p.device
    rad = lights.radiance[row].expand(n, 3)
    ones = torch.ones(n, device=dev)
    inf = torch.full((n,), INF, device=dev)

    def bc(x):
        return x.expand(n, *x.shape)

    if code == LT_DIRECTIONAL:
        return LightSample(rad, bc(lights.direction[row]), inf, ones)
    if code in (LT_POINT, LT_SPOT):
        wi, dist = _unit(lights.position[row] - p)
        if code == LT_SPOT:
            rad = rad * _spot_scale(wi, lights.direction[row], bc(lights.dim_x[row]))[:, None]
        return LightSample(rad, wi, dist, ones)
    if code == LT_AREA:
        return LightSample(*_area(
            lights.position[row], lights.dim_x[row], lights.dim_y[row], lights.direction[row],
            lights.area[row], rad, p, u,
        ))
    if code == LT_HEMISPHERE:
        return LightSample(rad, _hemisphere(u), inf, torch.full((n,), 1.0 / (2.0 * math.pi), device=dev))
    if code == LT_SPHERE:
        wi, dist, pdf = _sphere(lights.position[row], lights.dim_x[row, 0], p, u)
        return LightSample(rad, wi, dist, pdf.expand(n))
    if code == LT_MESH:
        mine = (lights.mesh_tri_light == row)[None, :]
        return LightSample(rad, *_mesh(lights, mine, lights.area[row], p, u))
    if code == LT_ENV:
        _need_env(env)
        es = sample_env(env, u)
        return LightSample(es.radiance, es.wi, inf, es.pdf)
    raise ValueError(f"unknown light type code {code}")
