"""The port's PNG reader against PIL, and the aperture masks it loads against the JAX package's.

``lens_flare_tpu_torch.utils.image.load_png`` decodes with ``zlib`` and
``struct`` only (the card's machine has no PIL).  It must give exactly the
array ``np.asarray(PIL.Image.open(path))`` gives, mode for mode, on files
PIL writes and on files filtered by hand with each of the five scanline
filters; what it does not cover raises a ValueError naming the case.
Tolerance: none, every comparison is exact (dtype, shape, values).
"""

import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from lens_flare_tpu.lens.aperture import ApertureTexture as JaxAperture
from lens_flare_tpu_torch.lens.aperture import ApertureTexture
from lens_flare_tpu_torch.utils.image import load_png

MODES = {  # PIL mode -> (array shape, dtype, value range)
    "L": ((29, 37), np.uint8, 256),
    "LA": ((29, 37, 2), np.uint8, 256),
    "RGB": ((29, 37, 3), np.uint8, 256),
    "RGBA": ((29, 37, 4), np.uint8, 256),
    "I;16": ((29, 37), np.uint16, 65536),
    "P": ((29, 37), np.uint8, 256),
}


def _pil_png(path, mode, seed=0):
    """A PNG of ``mode`` written by PIL: noise with smooth rows, so PIL's filter choice varies."""
    shape, dtype, top = MODES[mode]
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, top, shape).astype(dtype)
    arr[: shape[0] // 2] = np.cumsum(arr[: shape[0] // 2] % 3, axis=1).astype(dtype)  # smooth rows
    if mode == "P":
        im = Image.fromarray(np.repeat(arr[..., None], 3, axis=-1)).convert("P", palette=Image.ADAPTIVE)
    elif mode == "LA":
        im = Image.fromarray(arr, "LA")
    else:
        im = Image.fromarray(arr)
    im.save(path)
    return path


@pytest.mark.parametrize("mode", list(MODES))
def test_load_png_matches_pil(mode, tmp_path):
    path = _pil_png(tmp_path / "img.png", mode)
    with Image.open(path) as im:
        assert im.mode == mode
        want = np.asarray(im)
    got = load_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered_png(path, rows: np.ndarray, bpp: int, ftype, depth: int, ctype: int, width: int, interlace=0):
    """A PNG of raw scanlines ``rows`` (H, stride) uint8, each filtered by hand with ``ftype`` (or the list)."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = ftype[y % len(ftype)] if isinstance(ftype, list) else ftype
        enc = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            enc.append((x - pred) & 0xFF)
        out.append(bytes([f]) + bytes(enc))
        prior = row
    header = struct.pack(">IIBBBBB", width, rows.shape[0], depth, ctype, 0, 0, interlace)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))
    return path


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, [0, 1, 2, 3, 4]], ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", ["rgb8", "rgba16", "gray16"])
def test_each_filter(ftype, kind, tmp_path):
    """Hand-filtered scanlines decode to the pixels they encode, and to what PIL decodes."""
    rng = np.random.default_rng(7)
    h, w = 11, 13
    depth, ctype, ch = {"rgb8": (8, 2, 3), "rgba16": (16, 6, 4), "gray16": (16, 0, 1)}[kind]
    samples = rng.integers(0, 2**depth, (h, w * ch))
    samples[:4] = np.cumsum(samples[:4] % 5, axis=1) % 2**depth  # smooth rows
    raw = samples.astype(">u2").view(np.uint8) if depth == 16 else samples.astype(np.uint8)
    path = _filtered_png(tmp_path / "f.png", raw.reshape(h, -1), ch * depth // 8, ftype, depth, ctype, w)
    got = load_png(path)
    with Image.open(path) as im:
        want = np.asarray(im)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if kind == "gray16":  # 16-bit gray keeps every bit
        np.testing.assert_array_equal(got, samples.astype(np.uint16))
    else:  # PIL hands over 8-bit samples (16-bit ones as their high bytes)
        np.testing.assert_array_equal(got.reshape(h, -1), (samples >> (depth - 8)).astype(np.uint8))


def _vector_filtered_png(path, arr: np.ndarray, ftype: int):
    """An 8-bit RGBA PNG of ``arr`` (H, W, 4) with every scanline filtered by ``ftype`` (3 or 4), vectorised."""
    h, w, ch = arr.shape
    x = arr.reshape(h, w * ch).astype(np.int16)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = (a + b) >> 1 if ftype == 3 else np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), ftype, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
    return path


@pytest.mark.parametrize("ftype", [3, 4], ids=["average", "paeth"])
def test_mask_sized_file_decodes_in_time(ftype, tmp_path):
    """A 1024 x 1024 RGBA mask whose every row is Average- or Paeth-filtered (as libpng writes masks)
    decodes to its pixels, as PIL decodes it, in under 2 s: the diagonal sweep, not a Python loop over
    its 4 MiB of bytes."""
    arr = np.random.default_rng(11).integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
    path = _vector_filtered_png(tmp_path / "mask.png", arr, ftype)
    t0 = time.perf_counter()
    got = load_png(path)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got, arr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
    assert seconds < 2.0, f"load_png took {seconds:.2f} s on a 1024 x 1024 RGBA mask"


def test_uncovered_cases_raise(tmp_path):
    rows = np.zeros((4, 4), np.uint8)
    path = _filtered_png(tmp_path / "adam7.png", rows, 1, 0, 8, 0, 4, interlace=1)
    with pytest.raises(ValueError, match=r"interlaced \(Adam7\)"):
        load_png(path)
    path = _filtered_png(tmp_path / "gray4.png", np.zeros((4, 2), np.uint8), 1, 0, 4, 0, 4)
    with pytest.raises(ValueError, match="bit depth 4"):
        load_png(path)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        load_png(tmp_path / "not.png")


@pytest.mark.parametrize("mode", list(MODES))
def test_aperture_texture_load_matches_jax(mode, tmp_path):
    """ApertureTexture.load equals the JAX package's (PIL) on every mode, exactly."""
    path = _pil_png(tmp_path / "ap.png", mode, seed=3)
    got, want = ApertureTexture.load(path), JaxAperture.load(path)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype
    assert (got.total_value, got.min_x, got.min_y, got.max_x, got.max_y) == (
        want.total_value, want.min_x, want.min_y, want.max_x, want.max_y)
