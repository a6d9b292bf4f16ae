"""PNG output without PIL.

Counterpart of the writers in ``lens_flare_tpu/utils/image.py``, whose
NumPy transforms (``to_color``: the reference's gamma 2.2 / exposure
transform, ``sampling_rate_heatmap``) are imported as they are.  PNGs are
written with ``zlib`` and ``struct`` from the standard library, so the port
needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from lens_flare_tpu.utils.image import sampling_rate_heatmap, to_color  # noqa: F401


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def save_png(path, ldr: np.ndarray) -> None:
    """Save a [0, 1] float (H, W, 3) or (H, W) image as an 8-bit PNG."""
    arr = np.clip(np.round(np.asarray(ldr) * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        color_type = 0  # grayscale
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2  # RGB
    else:
        raise ValueError(f"want (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    # each scanline: filter byte 0 (None), then the row's samples
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_hdr_png(path, hdr: np.ndarray, flip_y: bool = False) -> None:
    """Gamma-correct an HDR film and save it (save_image, raytraced_renderer.cpp:717-755).

    Film row 0 is the bottom of the view: pass ``flip_y=True`` for an
    upright image.
    """
    ldr = to_color(np.asarray(hdr))
    if flip_y:
        ldr = ldr[::-1]
    save_png(path, ldr)
