"""The benchmark's own OpenEXR writer: a scanline RGB file of HALF channels, ZIP-compressed.

A frozen copy of the writer half of ``lens_flare_tpu_torch/utils/exr.py``
(kept here so that the yardstick shares no code with what it measures),
cut to what the config-3 sky is written as, after the OpenEXR file layout:
a header of attributes, a table of block offsets, then blocks of 16
scanlines, each EXR's byte interleave and delta predictor then deflate (a
block that would not shrink is stored raw).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
COMPRESSION_ZIP = 3
PIXELTYPE_HALF = 1
LINES_PER_BLOCK = 16


def _predict(raw: bytes) -> bytes:
    """EXR's interleave (even bytes first, then odd) and delta predictor, applied before deflate."""
    data = np.frombuffer(raw, dtype=np.uint8)
    half = (len(data) + 1) // 2
    split = np.empty(len(data), dtype=np.uint8)
    split[:half] = data[0::2]
    split[half:] = data[1::2]
    d = split.astype(np.int16)
    d[1:] = d[1:] - split[:-1].astype(np.int16) + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def write(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) array, each value rounded to float16 (largest finite 65504)."""
    img = np.asarray(img, dtype=np.float32).astype(np.float16)
    height, width = img.shape[:2]
    planes = [img[..., 2], img[..., 1], img[..., 0]]  # channels in the file's (alphabetical) order: B, G, R

    header = bytearray()

    def attr(name, atype, payload):
        header.extend(name.encode() + b"\x00" + atype.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload)

    chans = b"".join(c + b"\x00" + struct.pack("<iiii", PIXELTYPE_HALF, 0, 1, 1) for c in (b"B", b"G", b"R")) + b"\x00"
    box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    attr("channels", "chlist", chans)
    attr("compression", "compression", bytes([COMPRESSION_ZIP]))
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header.append(0)

    blocks = []
    for y0 in range(0, height, LINES_PER_BLOCK):
        # scanline by scanline, each channel's row in turn
        raw = np.stack([p[y0 : y0 + LINES_PER_BLOCK] for p in planes], axis=1).tobytes()
        packed = zlib.compress(_predict(raw))
        blocks.append((y0, packed if len(packed) < len(raw) else raw))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2) + bytes(header))
        pos = f.tell() + 8 * len(blocks)
        offsets = []
        for _, packed in blocks:
            offsets.append(pos)
            pos += 8 + len(packed)
        f.write(struct.pack(f"<{len(blocks)}q", *offsets))
        for y0, packed in blocks:
            f.write(struct.pack("<ii", y0, len(packed)) + packed)
