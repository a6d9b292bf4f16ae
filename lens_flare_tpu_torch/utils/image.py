"""Image transforms and PNG output without PIL.

Counterpart of ``lens_flare_tpu/utils/image.py``: NumPy copies of
``to_color`` (the reference's gamma 2.2 / exposure transform) and
``sampling_rate_heatmap``, and PNG writers built on ``zlib`` and ``struct``
from the standard library, so the port needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

GAMMA = 2.2
LEVEL = 1.0
# exposure = sqrt(2^level), image.h:212-213
EXPOSURE = float(np.sqrt(2.0 ** LEVEL))


def to_color(hdr: np.ndarray) -> np.ndarray:
    """HDR film -> [0,1] LDR, matching ``HDRImageBuffer::toColor`` (image.h:208-223).

    out = clamp((c * exposure) ** (1/gamma), 0, 1) with gamma=2.2, exposure=sqrt(2).
    """
    scaled = np.maximum(hdr * EXPOSURE, 0.0)
    return np.clip(scaled ** (1.0 / GAMMA), 0.0, 1.0)


def sampling_rate_heatmap(sample_counts: np.ndarray, max_samples: int) -> np.ndarray:
    """Sampling-rate image, matching ``save_sampling_rate`` (raytraced_renderer.cpp:757-788).

    Blue (low) -> green (mid) -> red (high) ramp over rate = count/max.
    """
    rate = np.asarray(sample_counts, dtype=np.float32) / float(max_samples)
    h, w = rate.shape
    out = np.zeros((h, w, 3), dtype=np.float32)
    lo = rate <= 0.5
    out[..., 0] = np.where(lo, 0.0, (rate - 0.5) * 2.0)
    out[..., 1] = np.where(lo, rate * 2.0, 1.0 - (rate - 0.5) * 2.0)
    out[..., 2] = np.where(lo, 1.0 - rate * 2.0, 0.0)
    return np.clip(out, 0.0, 1.0)


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
