"""Paraxial lens design in the port against the JAX package's ``diff.optimize``.

Inputs are made with NumPy from seeds and handed to both packages: the
smooth ghost splat (sigmoid edges, bilinear fetch) on the reference lens's
ghosts, ``ghost_image`` and its gradient with respect to every float field
of the prescription, and ``optimize_lens``'s losses.

Tolerances and why: images to 1e-5 of their peak and gradients to rtol
1e-4 (float32 on both sides; XLA:CPU fuses multiply-adds and the sigmoid
and the matrix chains round in another order); ``optimize_lens``'s losses
to rtol 1e-3 (optax and ``torch.optim.Adam`` order the update differently,
which drifts by ulps per step).  The composite of ghosts and starburst of
``tests/test_configs.py``'s north-star test is checked in float64 against
central differences at rtol 2e-3, as there.  A resumed optimization gives
the uninterrupted run's losses and lens bit for bit.  On the card
(``-m gpu``) the forward model and its gradient equal the CPU's to 1e-4
and 1e-3 of their peaks (CUDA's sigmoid and trigonometry round otherwise).
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu.diff import optimize as jopt
    from lens_flare_tpu.lens import ghosts as jgh
    from lens_flare_tpu.lens.paraxial import trace_all_ghosts as j_trace_all_ghosts
    from lens_flare_tpu.lens.prescription import reference_prescription as j_reference_prescription
except ImportError:  # the card's machine: only the gpu case can run
    jax = None

from lens_flare_tpu_torch.convert import prescription_from_numpy
from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS, OptimizeConfig, ghost_image, optimize_lens
from lens_flare_tpu_torch.flare.starburst import aperture_fft, starburst_field
from lens_flare_tpu_torch.lens import ghosts as tgh
from lens_flare_tpu_torch.lens.prescription import reference_prescription

W = H = 32
AXIS = np.array([0.6, 0.55], np.float32)
ANGLE = 0.35
TEX = np.clip(np.random.default_rng(0).uniform(0.2, 1.0, (12, 12)), 0, 1).astype(np.float32)
WINDOW = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores, and the
    small tensors here lose most of their time to oversubscribed thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_to_peak(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


@pytest.fixture(scope="module")
def ghosts():
    """The reference lens's ghost footprints (r1, r2), each (39,), and their colours."""
    r1, r2 = (np.asarray(x).reshape(-1) for x in j_trace_all_ghosts(j_reference_prescription(), jnp.float32(ANGLE)))
    return r1, r2, np.tile(np.eye(3, dtype=np.float32), (len(r1) // 3, 1))


def test_smooth_splat_matches_jax(ghosts):
    """splat_ghosts(smooth=True) and its gradient with respect to the footprints."""
    r1, r2, colors = ghosts

    def j_loss(a, b):
        out = jgh.splat_ghosts(jnp.asarray(TEX), a, b, jnp.asarray(colors), jnp.asarray(AXIS), W, H, smooth=True)
        return jnp.sum(out * WINDOW), out

    (_, want), (ga, gb) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(r1), jnp.asarray(r2))
    a, b = _t(r1, True), _t(r2, True)
    got = tgh.splat_ghosts(_t(TEX), a, b, _t(colors), _t(AXIS), W, H, smooth=True)
    torch.sum(got * _t(WINDOW)).backward()
    _close_to_peak(got.detach().numpy(), want)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=1e-4, atol=1e-4 * np.abs(ga).max())
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=1e-4, atol=1e-4 * np.abs(gb).max())
    # the exact splat is untouched by the smooth option
    exact = tgh.splat_ghosts(_t(TEX), _t(r1), _t(r2), _t(colors), _t(AXIS), W, H)
    want_exact = jgh.splat_ghosts(jnp.asarray(TEX), jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(colors),
                                  jnp.asarray(AXIS), W, H)
    _close_to_peak(exact.numpy(), want_exact, rel=1e-4)


@pytest.fixture(scope="module")
def jax_ghost_image():
    """JAX's ghost_image of the reference lens and the gradient of sum(window * image) in every field."""

    def loss(lens):
        img = jopt.ghost_image(lens, jnp.asarray(TEX), jnp.asarray(AXIS), ANGLE, W, H)
        return jnp.sum(img * WINDOW), img

    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(j_reference_prescription())
    return np.asarray(img), {f: np.asarray(getattr(g, f)) for f in LENS_FIELDS}


def test_ghost_image_matches_jax(jax_ghost_image):
    want, _ = jax_ghost_image
    got = ghost_image(reference_prescription(), _t(TEX), _t(AXIS), ANGLE, W, H)
    _close_to_peak(got.numpy(), want)


@pytest.mark.parametrize("field", LENS_FIELDS)
def test_ghost_image_gradient_matches_jax(field, jax_ghost_image):
    lens = reference_prescription()
    for f in LENS_FIELDS:
        getattr(lens, f).requires_grad_(True)
    img = ghost_image(lens, _t(TEX), _t(AXIS), ANGLE, W, H)
    torch.sum(img * _t(WINDOW)).backward()
    want = jax_ghost_image[1][field]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(getattr(lens, field).grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_composite_gradient_matches_central_differences():
    """Ghosts + FFT starburst in float64 (``tests/test_configs.py:172-230``): two curvatures, a spacing, two texels."""
    w = h = 48
    f64 = torch.float64
    tex = torch.tensor(np.clip(np.random.default_rng(0).uniform(0.2, 1.0, (12, 12)), 0, 1), dtype=f64)
    ap0 = torch.tensor(0.3 + 0.6 * np.random.default_rng(1).uniform(size=(16, 16)), dtype=f64)
    axis = torch.tensor([0.6, 0.55], dtype=f64)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=f64), torch.arange(w, dtype=f64), indexing="ij")
    window = torch.exp(-(((xx - 26.0) ** 2 + (yy - 30.0) ** 2) / 300.0))
    radiance = torch.tensor([1.0, 0.9, 0.8], dtype=f64)

    def loss(lens, ap):
        ghosts = ghost_image(lens, tex, axis, 0.35, w, h)
        sb = starburst_field(aperture_fft(ap), torch.sum(ap), ap0.shape[1], axis, radiance, w, h,
                             flare_intensity=1.0, flare_radius=0.3)
        return torch.sum((ghosts + sb) * window[:, :, None])

    lens0 = reference_prescription(dtype=f64)
    for f in LENS_FIELDS:
        getattr(lens0, f).requires_grad_(True)
    ap = ap0.clone().requires_grad_(True)
    loss(lens0, ap).backward()

    def shifted(field, idx, eps):
        lens = reference_prescription(dtype=f64)
        getattr(lens, field)[idx] += eps
        return lens

    checks = []
    with torch.no_grad():
        for field, idx in (("curvatures", 0), ("curvatures", 7), ("spacings", 2)):
            eps = 1e-6 * max(abs(float(getattr(lens0, field)[idx])), 1.0)
            fd = (float(loss(shifted(field, idx, eps), ap0)) - float(loss(shifted(field, idx, -eps), ap0))) / (2 * eps)
            checks.append((f"lens.{field}[{idx}]", fd, float(getattr(lens0, field).grad[idx])))
        for i, j in ((3, 5), (10, 2)):
            eps = 1e-6
            e = torch.zeros_like(ap0)
            e[i, j] = eps
            lens = reference_prescription(dtype=f64)
            fd = (float(loss(lens, ap0 + e)) - float(loss(lens, ap0 - e))) / (2 * eps)
            checks.append((f"aperture[{i},{j}]", fd, float(ap.grad[i, j])))
    for name, fd, an in checks:
        assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-3), (name, fd, an)
    assert any(abs(an) > 1e-3 for _, _, an in checks)


@pytest.fixture(scope="module")
def target():
    """Ghosts of the reference lens with 3% longer spacings (``tests/test_lens.py:157-177``), 24x24."""
    lens = reference_prescription()
    lens.spacings = lens.spacings * 1.03
    return ghost_image(lens, _t(TEX), _t(AXIS), ANGLE, 24, 24)


def test_optimize_lens_matches_jax(target):
    cfg = dict(steps=5, learning_rate=1e-4, log_every=0)
    _, losses = optimize_lens(target, TEX, AXIS, ANGLE, OptimizeConfig(**cfg), device="cpu")
    _, j_losses = jopt.optimize_lens(jnp.asarray(target.numpy()), jnp.asarray(TEX), jnp.asarray(AXIS), ANGLE,
                                     jopt.OptimizeConfig(**cfg))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert losses[-1] < losses[0]


def test_optimize_lens_resumes_from_checkpoint(target, tmp_path):
    """30 checkpointed steps, then a run to 35 from the directory: the 5 steps an uninterrupted run takes."""
    lens_full, full = optimize_lens(target, TEX, AXIS, ANGLE, OptimizeConfig(steps=35, log_every=0), device="cpu")
    assert full[29] < full[0] * 0.2, full[:3] + full[-3:]
    ck = str(tmp_path / "ck")
    cfg = OptimizeConfig(steps=30, log_every=0, checkpoint_dir=ck, checkpoint_every=10)
    _, first = optimize_lens(target, TEX, AXIS, ANGLE, cfg, device="cpu")
    assert first == full[:30]
    assert (tmp_path / "ck" / "LATEST").read_text() == "30" and (tmp_path / "ck" / "step_20.pt").exists()
    lens, rest = optimize_lens(target, TEX, AXIS, ANGLE, OptimizeConfig(steps=35, log_every=0, checkpoint_dir=ck),
                               device="cpu")
    assert rest == full[30:]  # only the remaining steps ran, with Adam's moments intact
    for f in LENS_FIELDS:
        assert torch.equal(getattr(lens, f), getattr(lens_full, f)), f
    assert lens.aperture_index == lens_full.aperture_index == 5


def test_prescription_from_jax_is_reference():
    """The lens both packages start from is the same, field for field."""
    got, want = reference_prescription(), prescription_from_numpy(j_reference_prescription())
    for f in LENS_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ghost_image_gradient_on_card_matches_cpu(cuda_device):
    """The forward model and its gradient in every field on the card, against the CPU's (1e-4, 1e-3 of each peak)."""
    out = {}
    for dev in ("cuda", "cpu"):
        lens = reference_prescription(device=dev)
        for f in LENS_FIELDS:
            getattr(lens, f).requires_grad_(True)
        img = ghost_image(lens, _t(TEX).to(dev), _t(AXIS).to(dev), ANGLE, W, H)
        torch.sum(img * _t(WINDOW).to(dev)).backward()
        out[dev] = img.detach().cpu(), {f: getattr(lens, f).grad.cpu() for f in LENS_FIELDS}
    _close_to_peak(out["cuda"][0].numpy(), out["cpu"][0].numpy(), rel=1e-4)
    for f in LENS_FIELDS:
        _close_to_peak(out["cuda"][1][f].numpy(), out["cpu"][1][f].numpy(), rel=1e-3)
