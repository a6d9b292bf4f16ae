"""The port's flare stages against the JAX package's, at a 64x48 film.

Tolerance: 1e-4 relative to the reference's maximum, per stage.  Both
sides compute in float32 but round differently in the last bits (XLA:CPU
fuses multiply-adds, the FFTs are different libraries, reductions run in
other orders); 1e-4 of the peak leaves room for that and for nothing else.
The PNG test is exact: the same HDR must give the same 8-bit pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.flare import pipeline as jpipe
from lens_flare_tpu.flare import starburst as jsb
from lens_flare_tpu.lens import ghosts as jgh
from lens_flare_tpu.lens.aperture import ApertureTexture as JaxTexture
from lens_flare_tpu.lens.paraxial import trace_all_ghosts as j_trace_all_ghosts
from lens_flare_tpu.lens.prescription import reference_prescription as j_reference_prescription
from lens_flare_tpu.utils import image as jimg
from lens_flare_tpu_torch import _rng
from lens_flare_tpu_torch.convert import prescription_from_numpy
from lens_flare_tpu_torch.flare import pipeline as tpipe
from lens_flare_tpu_torch.flare import starburst as tsb
from lens_flare_tpu_torch.lens import ghosts as tgh
from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
from lens_flare_tpu_torch.lens.paraxial import trace_all_ghosts
from lens_flare_tpu_torch.utils import image as timg

W, H = 64, 48
AXIS = np.array([0.31, 0.62], np.float32)  # sun in normalized screen coords
ANGLE = float(np.arctan2(AXIS[1], AXIS[0]))
RAD = np.array([[1.3, 1.1, 0.65]], np.float32)


def _close(got, want, rel=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def masks():
    return polygon_mask(40, 5, rotation=0.3), polygon_mask(24, 6)


@pytest.fixture(scope="module")
def ghosts_rr():
    jl = j_trace_all_ghosts(j_reference_prescription(), jnp.float32(ANGLE))
    return [np.asarray(x) for x in jl]


def test_trace_all_ghosts(ghosts_rr):
    lens = prescription_from_numpy(j_reference_prescription())
    r1, r2 = trace_all_ghosts(lens, torch.tensor(ANGLE, dtype=torch.float32))
    _close(r1.numpy(), ghosts_rr[0])
    _close(r2.numpy(), ghosts_rr[1])


@pytest.mark.parametrize("fast", [False, True], ids=["splat_ghosts", "splat_ghosts_fast"])
def test_ghost_splats(masks, ghosts_rr, fast):
    tex = masks[1]
    r1 = ghosts_rr[0].reshape(-1)
    r2 = ghosts_rr[1].reshape(-1)
    colors = np.tile(np.eye(3, dtype=np.float32), (len(r1) // 3, 1))
    jf = jgh.splat_ghosts_fast if fast else jgh.splat_ghosts
    tf = tgh.splat_ghosts_fast if fast else tgh.splat_ghosts
    want = jf(jnp.asarray(tex), jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(colors), jnp.asarray(AXIS), W, H)
    got = tf(*(torch.from_numpy(np.array(a)) for a in (tex, r1, r2, colors, AXIS)), W, H)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.numpy(), np.asarray(want))


def test_aperture_fft_and_starburst(masks):
    ap = masks[0][:32]  # wider than tall: exercises the zero-pad
    want_fft = np.asarray(jsb.aperture_fft(jnp.asarray(ap)))
    got_fft = tsb.aperture_fft(torch.from_numpy(ap)).numpy()
    _close(got_fft, want_fft)
    total = float(ap.sum())
    kw = dict(flare_intensity=1.5, flare_radius=30.0)
    want = jsb.starburst_field(jnp.asarray(want_fft), jnp.float32(total), ap.shape[1], jnp.asarray(AXIS), jnp.asarray(RAD[0]), W, H, **kw)
    got = tsb.starburst_field(torch.from_numpy(want_fft), total, ap.shape[1], torch.from_numpy(AXIS), torch.from_numpy(RAD[0]), W, H, **kw)
    _close(got.numpy(), np.asarray(want))


def test_irradiance_falloff_same_key():
    origins = np.array([[0.31, 0.62], [0.8, 0.1]], np.float32)
    rads = np.concatenate([RAD, [[0.5, 2.0, 1.0]]]).astype(np.float32)
    want = jsb.irradiance_falloff(jnp.asarray(origins), jnp.asarray(rads), W, H, jax.random.PRNGKey(3))
    got = tsb.irradiance_falloff(torch.from_numpy(origins), torch.from_numpy(rads), W, H, _rng.prng_key(3))
    _close(got.numpy(), np.asarray(want))


def test_pipeline_composite(masks):
    kw = dict(
        width=W, height=H, flare_origins=AXIS[None], flare_radiances=RAD, axis_ray=AXIS.astype(np.float64),
        angle_to_sun=ANGLE, flare_intensity=1.5, flare_radius=30.0, falloff_key=0,
    )
    jp = jpipe.FlarePipeline(
        aperture=JaxTexture.from_array(masks[0]), ghost_aperture=JaxTexture.from_array(masks[1]),
        lens=j_reference_prescription(), **kw,
    )
    tp = tpipe.FlarePipeline(
        aperture=ApertureTexture.from_array(masks[0]), ghost_aperture=ApertureTexture.from_array(masks[1]),
        lens=prescription_from_numpy(j_reference_prescription()), device="cpu", **kw,
    )
    hdr = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    want = np.asarray(jp.composite(jnp.asarray(hdr)))
    got = tp.composite(torch.from_numpy(hdr)).numpy()
    _close(got, want)
    assert (got >= hdr).all()  # the flare only adds light


def test_png_decodes_to_jax_pixels(tmp_path):
    from PIL import Image

    hdr = np.random.default_rng(1).uniform(0, 3, (H, W, 3)).astype(np.float32)
    jimg.save_hdr_png(tmp_path / "jax.png", hdr, flip_y=True)
    timg.save_hdr_png(tmp_path / "port.png", hdr, flip_y=True)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.dtype == np.uint8 and (got == want).all()
    gray = np.linspace(0, 1, W * H, dtype=np.float32).reshape(H, W)
    jimg.save_png(tmp_path / "jax_g.png", gray)
    timg.save_png(tmp_path / "port_g.png", gray)
    assert (np.asarray(Image.open(tmp_path / "port_g.png")) == np.asarray(Image.open(tmp_path / "jax_g.png"))).all()
