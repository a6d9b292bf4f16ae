"""Image transforms and PNG input and output without PIL.

Counterpart of ``lens_flare_tpu/utils/image.py``: NumPy copies of
``to_color`` (the reference's gamma 2.2 / exposure transform) and
``sampling_rate_heatmap``, a PNG reader and PNG writers built on ``zlib``
and ``struct`` from the standard library, so the port needs no imaging
package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9): rows (H, 1 + stride) -> (H, stride) uint8.

    A byte's predictor reads the reconstructed bytes to its left (a), above
    (b) and above-left (c), so the pixels of one anti-diagonal depend only
    on earlier diagonals.  Pixel (y, x) is stored at ``diag[y + x + 2, y + 1]``
    (the zero diagonals 0 and 1 and the zero row 0 stand for the bytes left
    of and above the image), and the diagonals are reconstructed in order:
    H + W - 1 vector steps for any mix of filters.
    """
    h, stride = rows.shape[0], rows.shape[1] - 1
    ftype = rows[:, 0]
    bad = np.flatnonzero(ftype > 4)
    if bad.size:
        raise ValueError(f"PNG scanline {bad[0]} has unknown filter type {ftype[bad[0]]}")
    w = stride // bpp
    y, x = np.divmod(np.arange(h * w), w)
    raw = np.zeros((h + w + 1, h, bpp), np.int16)
    raw[y + x + 2, y] = rows[:, 1:].reshape(h * w, bpp)
    diag = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    f = ftype[:, None]
    sub, up, avg, paeth = f == 1, f == 2, f == 3, f == 4
    for k in range(2, h + w + 1):
        lo, hi = max(0, k - 1 - w), min(h, k - 1)  # the rows that have a pixel on diagonal k
        a, b, c = diag[k - 1, lo + 1 : hi + 1], diag[k - 1, lo:hi], diag[k - 2, lo:hi]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where(paeth[lo:hi], np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)), 0)
        pred = np.where(avg[lo:hi], (a + b) >> 1, pred)
        pred = np.where(up[lo:hi], b, np.where(sub[lo:hi], a, pred))
        diag[k, lo + 1 : hi + 1] = (raw[k, lo:hi] + pred) & 0xFF
    return diag[y + x + 2, y + 1].astype(np.uint8).reshape(h, stride)


def load_png(path) -> np.ndarray:
    """Decode a PNG into the array ``np.asarray(PIL.Image.open(path))`` gives.

    Bit depths 8 and 16; gray, gray+alpha, RGB, RGBA and palette images;
    all five scanline filters.  Mode for mode, as PIL hands them over:
    8-bit gray (H, W) uint8, 16-bit gray (H, W) uint16, palette images their
    (H, W) uint8 index array, 8-bit gray+alpha (H, W, 2), RGB (H, W, 3) and
    RGBA (H, W, 4) uint8; 16-bit RGB and RGBA come back as their high bytes
    (uint8), and 16-bit gray+alpha as RGBA of its high bytes (L, L, L, A).
    Interlaced (Adam7) files and bit depths below 8 raise a ValueError
    that names the case.
    """
    data = Path(path).read_bytes()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not supported")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"{path}: {_COLOR_NAMES[ctype]} PNG of bit depth {depth} is not supported (8 or 16 only)")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown PNG compression {compression} or filter method {filtering}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, want {h * (w * bpp + 1)}")
    px = _unfilter(raw.reshape(h, w * bpp + 1), bpp)
    if depth == 16:
        if ctype == 0:
            return px.view(">u2").astype(np.uint16).reshape(h, w)
        px = px.reshape(h, w * ch, 2)[..., 0]  # high bytes
        if ctype == 4:
            la = px.reshape(h, w, 2)
            return np.stack([la[..., 0], la[..., 0], la[..., 0], la[..., 1]], axis=-1)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)
