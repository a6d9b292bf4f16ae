"""OpenEXR scanline reader and writer in pure Python (NumPy, ``struct``, ``zlib``).

Counterpart of ``lens_flare_tpu/utils/exr.py``: the same reader, for the
subset equirect environment maps use (single-part scanline files, HALF,
FLOAT and UINT channels, NONE, ZIPS or ZIP compression), and the same
writer, which can also store HALF channels (``pixel_type``), so the port
writes the 16-bit sky maps that are the usual interchange format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .profiling import span

MAGIC = 20000630
COMPRESSION_NONE = 0
COMPRESSION_ZIPS = 2  # 1 scanline per block
COMPRESSION_ZIP = 3  # 16 scanlines per block

PIXELTYPE_UINT = 0
PIXELTYPE_HALF = 1
PIXELTYPE_FLOAT = 2

_DTYPES = {PIXELTYPE_HALF: np.float16, PIXELTYPE_FLOAT: np.float32, PIXELTYPE_UINT: np.uint32}
_LINES_PER_BLOCK = {COMPRESSION_NONE: 1, COMPRESSION_ZIPS: 1, COMPRESSION_ZIP: 16}


def _read_null_string(buf: bytes, pos: int):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _postprocess_deflate(raw: bytes) -> bytes:
    """Undo EXR's delta predictor, then its interleave (first half -> even bytes, second -> odd)."""
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    d[1:] -= 128
    out = (np.cumsum(d) & 0xFF).astype(np.uint8)
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, dtype=np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _preprocess_deflate(raw: bytes) -> bytes:
    """EXR's interleave split and delta predictor, applied before deflate."""
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    split = np.empty(n, dtype=np.uint8)
    half = (n + 1) // 2
    split[:half] = data[0::2]
    split[half:] = data[1::2]
    d = split.astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def read(path) -> np.ndarray:
    """Read an EXR file -> (H, W, 3) float32 RGB (a single Y or other channel is repeated)."""
    with span("exr.read"):
        return _read(path)


def _read(path) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type), in the file's (alphabetical) order
    compression = None
    data_window = None
    while True:
        name, pos = _read_null_string(buf, pos)
        if name == "":
            break
        _attr_type, pos = _read_null_string(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_null_string(payload, cpos)
                ptype, _pl, _xs, _ys = struct.unpack_from("<iiii", payload, cpos)
                cpos += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)

    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1

    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {compression} not supported")
    lines_per_block = _LINES_PER_BLOCK[compression]

    num_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{num_blocks}q", buf, pos)

    # each scanline stores each channel's row contiguously
    chan_dtypes = [_DTYPES[pt] for _, pt in channels]
    chan_sizes = [np.dtype(dt).itemsize for dt in chan_dtypes]
    planes = {cname: np.zeros((height, width), dtype=np.float32) for cname, _ in channels}

    for off in offsets:
        (y_coord,) = struct.unpack_from("<i", buf, off)
        (packed_size,) = struct.unpack_from("<i", buf, off + 4)
        block = buf[off + 8 : off + 8 + packed_size]
        y0 = y_coord - y_min
        nlines = min(lines_per_block, height - y0)
        raw_size = sum(cs * width for cs in chan_sizes) * nlines
        if compression == COMPRESSION_NONE or len(block) == raw_size:
            raw = block  # a block that did not shrink is stored raw (EXR spec)
        else:
            raw = zlib.decompress(block)
            if len(raw) != raw_size:
                raise ValueError("unexpected decompressed block size")
            raw = _postprocess_deflate(raw)
        rpos = 0
        for line in range(nlines):
            for (cname, _pt), dt, cs in zip(channels, chan_dtypes, chan_sizes):
                row = np.frombuffer(raw, dtype=dt, count=width, offset=rpos)
                planes[cname][y0 + line] = row.astype(np.float32)
                rpos += cs * width

    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if "Y" in planes:
        y = planes["Y"]
        return np.stack([y, y, y], axis=-1)
    first = next(iter(planes.values()))
    return np.stack([first, first, first], axis=-1)


def write(path, img: np.ndarray, compression: int = COMPRESSION_ZIP, pixel_type: int = PIXELTYPE_FLOAT) -> None:
    """Write an (H, W, 3) array as a scanline RGB EXR of FLOAT (default) or HALF channels.

    HALF rounds each value to float16 (largest finite value 65504).
    """
    dtype = {PIXELTYPE_FLOAT: np.float32, PIXELTYPE_HALF: np.float16}[pixel_type]
    img = np.asarray(img, dtype=np.float32).astype(dtype)
    height, width = img.shape[:2]
    chans = [("B", img[..., 2]), ("G", img[..., 1]), ("R", img[..., 0])]

    header = bytearray()

    def attr(name, atype, payload):
        header.extend(name.encode() + b"\x00" + atype.encode() + b"\x00")
        header.extend(struct.pack("<i", len(payload)))
        header.extend(payload)

    chan_payload = bytearray()
    for cname, _ in chans:
        chan_payload.extend(cname.encode() + b"\x00")
        chan_payload.extend(struct.pack("<iiii", pixel_type, 0, 1, 1))
    chan_payload.append(0)
    attr("channels", "chlist", bytes(chan_payload))
    attr("compression", "compression", bytes([compression]))
    box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header.append(0)

    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (height + lines_per_block - 1) // lines_per_block

    blocks = []
    for b in range(num_blocks):
        y0 = b * lines_per_block
        nlines = min(lines_per_block, height - y0)
        # scanline by scanline, each channel's row in turn
        raw = np.stack([plane[y0 : y0 + nlines] for _, plane in chans], axis=1).tobytes()
        if compression == COMPRESSION_NONE:
            packed = raw
        else:
            packed = zlib.compress(_preprocess_deflate(raw))
            if len(packed) >= len(raw):
                packed = raw
        blocks.append((y0, packed))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(bytes(header))
        table_pos = f.tell()
        f.seek(table_pos + 8 * num_blocks)
        offsets = []
        for y0, packed in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(packed)))
            f.write(packed)
        f.seek(table_pos)
        f.write(struct.pack(f"<{num_blocks}q", *offsets))
