"""Aperture-mask textures (starburst and ghost masks).

Counterpart of ``lens_flare_tpu/lens/aperture.py`` (``CameraApertureTexture``,
``camera.h:18-88``), which cannot be imported here: its package's
``__init__`` pulls in JAX.  PIL is imported only by :meth:`load`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ApertureTexture:
    values: np.ndarray  # (H, W) float32 in [0, 1]
    total_value: float
    min_x: int
    min_y: int
    max_x: int
    max_y: int

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def height(self) -> int:
        return self.values.shape[0]

    @classmethod
    def load(cls, path) -> "ApertureTexture":
        """Grayscale PNG -> texture: red channel scaled to [0, 1] (camera.h:26-83)."""
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im)
        red = arr if arr.ndim == 2 else arr[..., 0]
        if red.dtype == np.uint8:
            return cls.from_array(red.astype(np.float32) / 255.0)
        if red.dtype == np.uint16:
            return cls.from_array(red.astype(np.float32) / 65535.0)
        return cls.from_array(red.astype(np.float32))

    @classmethod
    def from_array(cls, values: np.ndarray) -> "ApertureTexture":
        values = np.asarray(values, np.float32)
        ys, xs = np.nonzero(values > 0)
        if len(xs) == 0:
            min_x = min_y = values.shape[1]
            max_x = max_y = -1
        else:
            min_x, max_x = int(xs.min()), int(xs.max())
            min_y, max_y = int(ys.min()), int(ys.max())
        return cls(
            values=values, total_value=float(values.sum()),
            min_x=min_x, min_y=min_y, max_x=max_x, max_y=max_y,
        )


def polygon_mask(size: int, sides: int, radius: float = 0.42, rotation: float = 0.0) -> np.ndarray:
    """(size, size) float32 mask of a regular polygon centred in the square.

    Stands in for the iris PNGs when no asset files are at hand: each texel
    is 1 if its centre lies inside the polygon (circumradius ``radius`` in
    units of ``size``), else 0.
    """
    c = (np.arange(size) + 0.5) / size - 0.5
    x, y = np.meshgrid(c, c)
    inside = np.ones((size, size), bool)
    apothem = radius * np.cos(np.pi / sides)
    for i in range(sides):
        a = rotation + 2 * np.pi * (i + 0.5) / sides
        inside &= x * np.cos(a) + y * np.sin(a) <= apothem
    return inside.astype(np.float32)
