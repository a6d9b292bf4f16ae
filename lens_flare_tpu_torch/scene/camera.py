"""Camera parameters on the device and pinhole ray generation.

Counterpart of ``lens_flare_tpu/scene/camera.py``.  The host-side
:class:`~lens_flare_tpu.scene.camera.Camera` (orbit placement, FOV fixup,
world -> screen projection) is NumPy-only and is imported from the JAX
package as it is; this module holds the device half: ``CameraParams`` as
tensors and :func:`generate_rays` (``camera.py:242``).  Thin-lens and bokeh
ray generation are not ported yet (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

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


def generate_rays(params: CameraParams, x: torch.Tensor, y: torch.Tensor):
    """Pinhole rays for normalized sensor coords x, y in [0, 1], shape (N,).

    Returns (origins (N, 3), directions (N, 3)), as ``generate_rays``.
    """
    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
    d_cam = d_cam / _norm3(d_cam)[:, None]
    c = params.c2w
    d_world = torch.stack(
        [d_cam[:, 0] * c[i, 0] + d_cam[:, 1] * c[i, 1] + d_cam[:, 2] * c[i, 2] for i in range(3)],
        dim=-1,
    )
    origins = params.pos.expand(d_world.shape)
    return origins, d_world
