"""BSDF family codes and the material record.

Counterpart of the constants and ``MaterialInfo`` of
``lens_flare_tpu/scene/collada.py`` (``:34-40``, ``:74-87``), copied so that
the port needs nothing from the JAX package.  The COLLADA XML loader itself
is not ported yet (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# BSDF families (bsdf.h:119-288); indices shared with the shading tables.
BSDF_DIFFUSE = 0
BSDF_EMISSION = 1
BSDF_MIRROR = 2
BSDF_MICROFACET = 3
BSDF_REFRACTION = 4
BSDF_GLASS = 5


@dataclass
class MaterialInfo:
    """Material resolved to a BSDF family + parameters (collada.cpp:863-954)."""

    bsdf_type: int = BSDF_DIFFUSE
    albedo: np.ndarray = field(default_factory=lambda: np.full(3, 0.5))  # diffuse reflectance
    radiance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # emission
    reflectance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # mirror/glass
    transmittance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # refraction/glass
    eta: np.ndarray = field(default_factory=lambda: np.zeros(3))  # microfacet
    k: np.ndarray = field(default_factory=lambda: np.zeros(3))  # microfacet
    alpha: float = 0.0  # microfacet roughness
    roughness: float = 0.0  # refraction/glass
    ior: float = 1.0  # refraction/glass
