"""Lens prescription as a dataclass of tensors.

Counterpart of ``lens_flare_tpu/lens/prescription.py``: the reference's
hardcoded 9-interface lens (``pathtracer.cpp:539-556``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class LensPrescription:
    """N-interface paraxial prescription (N = 9 for the reference lens)."""

    spacings: torch.Tensor  # (N,) gap after interface i
    curvatures: torch.Tensor  # (N+1,) surface curvatures
    iors: torch.Tensor  # (3, N) refractive index after interface i, per RGB
    aperture_height: torch.Tensor  # () half-height of the iris
    marginal_r: torch.Tensor  # () marginal ray height
    aperture_index: int = 5

    @property
    def num_interfaces(self) -> int:
        return self.spacings.shape[0]


def reference_prescription(device=None, dtype=torch.float32) -> LensPrescription:
    """The reference's lens (pathtracer.cpp:539-556)."""
    spacings = [7.700, 1.850, 3.520, 1.850, 4.180, 3.000, 1.850, 7.270, 83.91]
    curvatures = [
        1 / 30.810, 1 / -89.350, 1 / 580.380, 1 / -80.630, 1 / 28.340,
        0.0, 0.0, 1 / 32.190, 1 / -52.990, 1 / 81.320,
    ]
    red = [1.652, 1.5991, 1, 1.6396, 1, 1, 1.5776, 1.68990, 1]
    green = [1.652, 1.6113, 1, 1.65, 1, 1, 1.5885, 1.6999, 1]
    blue = [1.652, 1.6164, 1, 1.6542, 1, 1, 1.5930, 1.7040, 1]

    def t(v):
        # round through numpy float64 -> dtype, as the JAX package does
        return torch.as_tensor(np.asarray(v, np.float64), device=device).to(dtype)

    return LensPrescription(
        spacings=t(spacings),
        curvatures=t(curvatures),
        iors=t([red, green, blue]),
        aperture_height=t(11.6),
        marginal_r=t(14.5),
        aperture_index=5,
    )
