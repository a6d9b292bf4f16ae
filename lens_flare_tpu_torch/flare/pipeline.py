"""Lens-flare pipeline: sun finding, ghosts, starburst, falloff, compositing.

Counterpart of ``lens_flare_tpu/flare/pipeline.py`` on the paraxial lens
model (``start_raytracing``, raytraced_renderer.cpp:305-311, plus the
per-pixel additions at pathtracer.cpp:881-891): ghosts need a sun on
screen, the starburst a non-empty aperture mask, and the falloff glow
applies whenever a sun is on screen.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _rng
from ..lens.aperture import ApertureTexture
from ..lens.ghosts import splat_ghosts, splat_ghosts_fast
from ..lens.paraxial import trace_all_ghosts
from ..lens.prescription import LensPrescription, reference_prescription
from ..scene.build import LT_DIRECTIONAL
from .starburst import aperture_fft, irradiance_falloff, starburst_field


def find_sun(light_table, camera):
    """Project directional lights to screen (find_sun_pos, pathtracer.cpp:32-64).

    Returns (origins (F, 2), radiances (F, 3), axis_ray (2,), angle_to_sun).
    """
    origins, radiances = [], []
    axis_ray = np.zeros(2)
    angle = 0.0
    for li in range(len(light_table.light_type)):
        if light_table.light_type[li] != LT_DIRECTIONAL:
            continue
        ns_x, ns_y = camera.analyze_world_coord(light_table.position[li])
        if 0 <= ns_x <= 1 and 0 <= ns_y <= 1:
            origins.append([ns_x, ns_y])
            radiances.append(light_table.radiance[li])
            # atan2 == C++ atan(ns_y / ns_x) on this domain, ns_x == 0 included
            angle = math.atan2(ns_y, ns_x)
            axis_ray = np.array([ns_x, ns_y])
    return (
        np.asarray(origins, np.float32).reshape(-1, 2),
        np.asarray(radiances, np.float32).reshape(-1, 3),
        axis_ray,
        angle,
    )


@dataclass
class FlarePipeline:
    width: int
    height: int
    flare_origins: np.ndarray  # (F, 2)
    flare_radiances: np.ndarray  # (F, 3)
    axis_ray: np.ndarray  # (2,)
    angle_to_sun: float
    aperture: ApertureTexture | None = None
    ghost_aperture: ApertureTexture | None = None
    lens: LensPrescription = None
    flare_intensity: float = 0.0
    flare_radius: float = 0.0
    falloff_key: int = 0
    # "exact" rasterizer, "fast" canonical-card resample, "auto": fast from 2^18 pixels
    ghost_method: str = "auto"
    device: str = "cuda"  # as Renderer: the card unless the caller asks for the CPU
    _fft_cache: torch.Tensor | None = None

    @classmethod
    def from_renderer(cls, renderer) -> "FlarePipeline | None":
        origins, radiances, axis_ray, angle = find_sun(renderer.scene.lights, renderer.camera)
        if len(origins) == 0:
            return None

        def texture(tex, path):
            return tex if tex is not None else (ApertureTexture.load(path) if path else None)

        return cls(
            width=renderer.width,
            height=renderer.height,
            flare_origins=origins,
            flare_radiances=radiances,
            axis_ray=axis_ray,
            angle_to_sun=angle,
            aperture=texture(renderer.aperture, renderer.aperture_path),
            ghost_aperture=texture(renderer.ghost_aperture, renderer.ghost_aperture_path),
            lens=reference_prescription(device=renderer.device),
            flare_intensity=renderer.flare_intensity,
            flare_radius=renderer.flare_radius,
            falloff_key=renderer.seed,
            device=renderer.device,
        )

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _zeros(self):
        return torch.zeros((self.height, self.width, 3), device=self.device)

    def ghost_buffer(self) -> torch.Tensor:
        """(H, W, 3) additive ghost buffer (generate_ghost_buffer)."""
        if (self.axis_ray == 0).all():
            return self._zeros()
        if self.ghost_aperture is None or self.ghost_aperture.total_value == 0:
            return self._zeros()
        method = self.ghost_method
        if method == "auto":
            method = "fast" if self.width * self.height >= (1 << 18) else "exact"
        lens = self.lens
        r1, r2 = trace_all_ghosts(lens, torch.tensor(self.angle_to_sun, dtype=torch.float32))
        n_pairs = r1.shape[0]
        colors = torch.eye(3, device=r1.device).repeat(n_pairs, 1)
        tex = self._t(self.ghost_aperture.values)
        axis = self._t(self.axis_ray)
        splat = splat_ghosts_fast if method == "fast" else splat_ghosts
        return splat(tex, r1.reshape(-1), r2.reshape(-1), colors, axis, self.width, self.height)

    def starburst(self) -> torch.Tensor:
        """(H, W, 3) starburst field (raytrace_starburst minus falloff)."""
        if self.aperture is None or self.aperture.total_value == 0 or len(self.flare_origins) == 0:
            return self._zeros()
        if self._fft_cache is None:
            self._fft_cache = aperture_fft(self._t(self.aperture.values))
        return starburst_field(
            self._fft_cache,
            self.aperture.total_value,
            self.aperture.width,
            self._t(self.flare_origins[0]),
            self._t(self.flare_radiances.sum(axis=0)),
            self.width,
            self.height,
            flare_intensity=self.flare_intensity,
            flare_radius=self.flare_radius,
        )

    def falloff(self) -> torch.Tensor:
        if len(self.flare_origins) == 0:
            return self._zeros()
        return irradiance_falloff(
            self._t(self.flare_origins),
            self._t(self.flare_radiances),
            self.width,
            self.height,
            _rng.prng_key(self.falloff_key, device=self.device),
        )

    def composite(self, hdr: torch.Tensor) -> torch.Tensor:
        """film + ghost + starburst + falloff (pathtracer.cpp:891)."""
        return hdr + self.ghost_buffer() + self.starburst() + self.falloff()
