"""Camera parameters on the device and pinhole ray generation.

Counterpart of ``lens_flare_tpu/scene/camera.py``.  The host-side
:class:`~lens_flare_tpu.scene.camera.Camera` (orbit placement, FOV fixup,
world -> screen projection) is NumPy-only and is imported from the JAX
package as it is; this module holds the device half: ``CameraParams`` as
tensors, pinhole, thin-lens and bokeh ray generation (``camera.py:242-306``)
and :func:`project_world_to_screen` (``:309``).  Matrix products are written
as explicit sums so that they round as XLA's three-term dot products do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lens_flare_tpu.scene.camera import Camera  # noqa: F401  (host class, NumPy only)


class CameraParams(NamedTuple):
    """Camera state ray generation needs, as float32 tensors on one device."""

    c2w: torch.Tensor  # (3, 3) columns = [screenX, screenY, dirToCamera]
    pos: torch.Tensor  # (3,)
    tan_half_h: torch.Tensor  # ()
    tan_half_v: torch.Tensor
    n_clip: torch.Tensor
    f_clip: torch.Tensor
    lens_radius: torch.Tensor
    focal_distance: torch.Tensor


def camera_params(camera: Camera, device) -> CameraParams:
    """``Camera.params()`` (``camera.py:199``) moved onto ``device``."""
    p = camera.params()
    return CameraParams(
        *(torch.as_tensor(v, dtype=torch.float32, device=device) for v in p)
    )


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _to_world(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v @ c.T for v (N, 3): camera space -> world space."""
    return torch.stack(
        [v[:, 0] * c[i, 0] + v[:, 1] * c[i, 1] + v[:, 2] * c[i, 2] for i in range(3)], dim=-1
    )


def generate_rays(params: CameraParams, x: torch.Tensor, y: torch.Tensor):
    """Pinhole rays for normalized sensor coords x, y in [0, 1], shape (N,).

    Returns (origins (N, 3), directions (N, 3)), as ``generate_rays``.
    """
    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
    d_cam = d_cam / _norm3(d_cam)[:, None]
    d_world = _to_world(params.c2w, d_cam)
    origins = params.pos.expand(d_world.shape)
    return origins, d_world


def _lens_rays(params: CameraParams, x, y, p_lens):
    """Rays from lens points p_lens (N, 3, camera space) through the focal plane."""
    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    # the point on the plane of focus along the pinhole direction
    p_focus = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1) * params.focal_distance
    d_cam = p_focus - p_lens
    d_cam = d_cam / _norm3(d_cam)[:, None]
    c = params.c2w
    return params.pos + _to_world(c, p_lens), _to_world(c, d_cam)


def generate_rays_thin_lens(params: CameraParams, x, y, rnd_r, rnd_theta):
    """Thin-lens rays (``camera.py:258``): a lens-disk point of radius
    ``lens_radius`` from the uniforms rnd_r, rnd_theta, aimed at the focal-plane
    point of the pinhole ray.  Returns (origins (N, 3), directions (N, 3)).
    """
    r = params.lens_radius * torch.sqrt(rnd_r)
    theta = 2.0 * math.pi * rnd_theta
    p_lens = torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
    return _lens_rays(params, x, y, p_lens)


def generate_rays_bokeh(params: CameraParams, x, y, lens_uv):
    """Thin-lens rays whose lens point is a bokeh-mask sample (``camera.py:284``).

    ``lens_uv``: (N, 2) points in [-0.5, 0.5]^2 (``BokehMask.sample``), scaled
    by 2 * lens_radius so that the mask spans the lens diameter.
    """
    scale = 2.0 * params.lens_radius
    p_lens = torch.stack(
        [lens_uv[:, 0] * scale, lens_uv[:, 1] * scale, torch.zeros_like(lens_uv[:, 0])], dim=-1
    )
    return _lens_rays(params, x, y, p_lens)


def project_world_to_screen(params: CameraParams, pos_world: torch.Tensor):
    """World points (N, 3) -> normalized screen coords (ns_x, ns_y) (``camera.py:309``)."""
    rel = pos_world - params.pos
    c = params.c2w
    pos_camera = torch.stack(  # rel @ c2w
        [rel[:, 0] * c[0, j] + rel[:, 1] * c[1, j] + rel[:, 2] * c[2, j] for j in range(3)], dim=-1
    )
    pos_image = pos_camera / torch.abs(pos_camera[:, 2:3])
    ns_x = ((pos_image[:, 0] / params.tan_half_h) + 1) / 2.0
    ns_y = ((pos_image[:, 1] / params.tan_half_v) + 1) / 2.0
    return ns_x, ns_y
