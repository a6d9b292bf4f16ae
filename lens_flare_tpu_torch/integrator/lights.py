"""Light tables and per-slot light sampling (directional and point lights).

Counterpart of ``lens_flare_tpu/integrator/lights.py``: ``LightArrays``,
``lights_to_device`` and ``sample_light_static`` (``lights.py:252``).  The
other light types (hemisphere, area, spot, env, sphere, mesh) are refused by
:func:`lens_flare_tpu_torch.integrator.path.make_settings` (ROADMAP Queue 1,
item 4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.build import LT_DIRECTIONAL, LT_POINT

INF = 1e30
PORTED_LIGHT_TYPES = (LT_DIRECTIONAL, LT_POINT)


class LightArrays(NamedTuple):
    """Per-light rows; types and the slot plan stay on the host (RenderSettings)."""

    radiance: torch.Tensor  # (L, 3)
    position: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3) directional: dirToLight


class LightSample(NamedTuple):
    radiance: torch.Tensor  # (N, 3)
    wi: torch.Tensor  # (N, 3) world, towards the light
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,)


def lights_to_device(table, device) -> LightArrays:
    return LightArrays(
        radiance=torch.as_tensor(np.asarray(table.radiance, np.float32), device=device),
        position=torch.as_tensor(np.asarray(table.position, np.float32), device=device),
        direction=torch.as_tensor(np.asarray(table.direction, np.float32), device=device),
    )


def sample_light_static(lights: LightArrays, row: int, code: int, p: torch.Tensor, u: torch.Tensor) -> LightSample:
    """sample_L for one host-known light row at points p (N, 3).

    Directional (light.cpp:19-24) and point (light.cpp:51-58) lights are
    delta lights: the uniforms ``u`` are not used.
    """
    n = p.shape[0]
    rad = lights.radiance[row].expand(n, 3)
    ones = torch.ones(n, device=p.device)
    if code == LT_DIRECTIONAL:
        wi = lights.direction[row].expand(n, 3)
        return LightSample(rad, wi, torch.full((n,), INF, device=p.device), ones)
    if code == LT_POINT:
        d = lights.position[row] - p
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        wi = d / torch.clamp_min(dist, 1e-30)[:, None]
        return LightSample(rad, wi, dist, ones)
    raise NotImplementedError(
        f"light type {code} is not ported yet (ROADMAP Queue 1, item 4)"
    )
