"""BSDF tables, shading frames, evaluation and sampling (diffuse and emission).

Counterpart of ``lens_flare_tpu/integrator/shading.py``.  This slice ports
the diffuse and emission families; a scene with any other family is refused
by :func:`lens_flare_tpu_torch.integrator.path.make_settings` (ROADMAP
Queue 1, item 4).  Conventions are the reference's: directions in the local
frame have +z along the normal, and ``eval_f`` takes wi negated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.collada import BSDF_DIFFUSE, BSDF_EMISSION

PORTED_FAMILIES = (BSDF_DIFFUSE, BSDF_EMISSION)


class BSDFArrays(NamedTuple):
    bsdf_type: torch.Tensor  # (B,) int32
    albedo: torch.Tensor  # (B, 3)
    radiance: torch.Tensor  # (B, 3)


def bsdf_to_device(table, device) -> BSDFArrays:
    return BSDFArrays(
        bsdf_type=torch.as_tensor(np.asarray(table.bsdf_type, np.int32), device=device),
        albedo=torch.as_tensor(np.asarray(table.albedo, np.float32), device=device),
        radiance=torch.as_tensor(np.asarray(table.radiance, np.float32), device=device),
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


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


def get_emission(bsdfs: BSDFArrays, b: torch.Tensor) -> torch.Tensor:
    """Radiance for emission BSDFs, 0 otherwise."""
    b = b.long()
    is_em = (bsdfs.bsdf_type[b] == BSDF_EMISSION)[:, None]
    return torch.where(is_em, bsdfs.radiance[b], 0.0)


def eval_f(bsdfs: BSDFArrays, b: torch.Tensor, wi_neg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """BSDF::f(-wi, wo) -> (N, 3): albedo / pi for diffuse rows, 0 for emitters."""
    b = b.long()
    f_diffuse = bsdfs.albedo[b] / math.pi  # bsdf.cpp:52-61
    return torch.where((bsdfs.bsdf_type[b] == BSDF_DIFFUSE)[:, None], f_diffuse, 0.0)


class BSDFSample(NamedTuple):
    f: torch.Tensor  # (N, 3)
    wi: torch.Tensor  # (N, 3) local frame, away from the surface
    pdf: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


def sample_f(bsdfs: BSDFArrays, b: torch.Tensor, wo: torch.Tensor, u: torch.Tensor) -> BSDFSample:
    """One importance sample per lane; u (N, 3) uniforms (u[:, 2] is unused here).

    Diffuse: cosine-weighted hemisphere (sampler.cpp:58-68).  Emission rows
    take the same direction with f = 0 (bsdf.cpp:95-101).
    """
    b = b.long()
    xi1, xi2 = u[:, 0], u[:, 1]
    r = torch.sqrt(xi1)
    phi = 2.0 * math.pi * xi2
    z_cos = torch.sqrt(torch.clamp_min(1.0 - xi1, 0.0))
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z_cos], dim=-1)
    pdf = z_cos / math.pi
    f = bsdfs.albedo[b] / math.pi
    f = torch.where((bsdfs.bsdf_type[b] == BSDF_EMISSION)[:, None], 0.0, f)
    return BSDFSample(f=f, wi=wi, pdf=pdf, valid=pdf > 0)
