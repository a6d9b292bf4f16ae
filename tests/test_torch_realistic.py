"""The realistic lens stack of the port against ``lens_flare_tpu.lens.realistic`` and ``.paraxial``.

Inputs are made with NumPy from seeds, or are the reference lens, and both
packages get the same values: ``fresnel_dielectric``, ``_intersect_surface``
and ``_refract`` lane by lane, the per-pair and batched traces for all 13
pairs x 3 wavelengths, ``physical_ghost_matrix`` and the jacobian of the
stack at (h, theta) = (0, 0), ``render_ghosts_stack`` and its gradient in
every float field of the prescription, the Adam recovery of curvature 7,
the realistic and paraxial ``FlarePipeline`` on a ``chip_smoke.terrain_dae``
scene whose sun is on screen, and the command line with ``--lens-model
realistic``.

Tolerances and why (the largest differences read on the CPU in brackets):

- float64, both packages in double: the same formulas in another order of
  summation.  Lane functions, traces and images to rtol 1e-12 (t 5.7e-14
  absolute; xy 6.9e-12 absolute on values up to ~720; images 1.8e-13 of
  their peak), ``physical_ghost_matrix`` to rtol 1e-12 (equal), the loss
  to 1e-12 and each field's gradient to 1e-9 of its largest value
  (1.9e-14; the aperture height has none in either package: the iris
  clips by a step);
- float32: XLA:CPU contracts the dot products and ``jnp.linalg.norm`` into
  fused multiply-adds and the port rounds every product (ROADMAP Queue 3
  item 4), and a ghost's 11-17 surfaces amplify a last-bit difference.
  Lane functions to rtol and atol 1e-5 (3.8e-6 on a t of tens; 6e-8 on
  Fresnel); traces at the JAX package's own tolerances between its
  batched and unrolled traces (``tests/test_lens.py:360-371``): energy
  rtol 2e-5 and atol 1e-6 (2.1e-8), xy rtol and atol 1e-3 on live lanes
  (0.21 on a value of ~720, 2.9e-4 relative), live lanes equal; images
  to 1e-3 of their peak (1.4e-4): JAX's xy tolerance of 1e-3 sensor units
  moves a tap by 4e-4 pixels at ``sensor_scale`` 0.4, and its bilinear
  weights by up to 8e-4.  The port's batched trace against its own
  unrolled one at those tolerances read 0 (bit-equal);
- ``physical_ghost_matrix`` against the jacobian of the port's stack at
  (0, 0), float64: rtol 1e-8 and atol 1e-10, as ``tests/test_lens.py:393``
  (9.5e-13 absolute);
- the float64 stack's gradient against central differences: rtol 2e-3, as
  ``tests/test_lens.py:248`` (1.2e-9);
- the pipelines: the realistic ones and the paraxial one with the fast
  splat as the float32 images (1.2e-4; 2.6e-4), the exact paraxial splat at
  ``tests/test_torch_flare.py``'s 1e-4; the PNGs of both
  command lines within one 8-bit level on >= 99% of values, as
  ``tests/test_torch_cli.py``.

The buffer's taps are summed by ``realistic.ordered_sum`` (a stable sort,
a segmented scan, one write per pixel) in place of ``index_add``, whose
float atomics add in no fixed order on the card: against float64
``index_add`` (sequential on the CPU) to 1e-6 relative from float32 and 1e-14 from float64,
a small pixel beside a large one included, and its gradient equal to the
gather of the cotangent.

On the card (``-m gpu``), see ``test_realistic_on_card_matches_cpu``: the
card rounds the trace otherwise (its reductions and trigonometry), so
float32 is held at the float32 tolerances and float64 is the witness that
the card's trace and backward compute what the CPU's do.
``test_ghost_buffer_is_reproducible_on_card``: two card runs of the buffer
and of its gradient, and the buffer replayed from a captured program
against an eager one, bit for bit.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu import cli as j_cli
    from lens_flare_tpu.flare.pipeline import FlarePipeline as JaxPipeline
    from lens_flare_tpu.lens import paraxial as j_par
    from lens_flare_tpu.lens import realistic as j_real
    from lens_flare_tpu.lens.prescription import reference_prescription as j_reference_prescription
    from lens_flare_tpu.renderer import Renderer as JaxRenderer
except ImportError:  # the card's machine: only the gpu case can run
    jax = None

import chip_smoke
from lens_flare_tpu_torch import cli
from lens_flare_tpu_torch.convert import prescription_from_numpy
from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS
from lens_flare_tpu_torch.lens import paraxial, realistic
from lens_flare_tpu_torch.lens.prescription import reference_prescription
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.utils.image import load_png

PAIRS = [tuple(p) for p in paraxial.reference_ghost_pairs()]
SUBSET = ((0, 1), (2, 4), (6, 8))  # before, across and after the iris
AXIS = (0.6, 0.55)
RADIANCE = (1.0, 0.9, 0.7)
F32 = dict(trace_energy=(2e-5, 1e-6), trace_xy=(1e-3, 1e-3), image=1e-3, lane=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def precision(dtype):
    """JAX in double for float64 (a process-wide switch, restored after), else as it is."""
    if dtype != torch.float64:
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def lenses(dtype):
    """(JAX lens, port lens) of the reference prescription at ``dtype``; call under ``precision``."""
    jl = j_reference_prescription(jnp.float64 if dtype == torch.float64 else jnp.float32)
    return jl, prescription_from_numpy(jl, dtype=dtype)


def np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def close_to_peak(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.abs(want).max() > 0
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def random_rays(n, seed, dtype, angle=0.3):
    """Pupil rays at z = -1 over the front element, and a collimated direction tilted by ``angle``."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-14, 14, n), rng.uniform(-14, 14, n), np.full(n, -1.0)], -1).astype(np_dtype(dtype))
    d = np.broadcast_to(np.array([np.sin(angle), 0.0, np.cos(angle)], np_dtype(dtype)), o.shape).copy()
    return o, d


def test_prescription_from_numpy_keeps_float64():
    """dtype=float64 carries a double JAX lens across unrounded; the default still rounds to float32."""
    with precision(torch.float64):
        jl = j_reference_prescription(jnp.float64)
        lens = prescription_from_numpy(jl, dtype=torch.float64)
    assert lens.curvatures.dtype == torch.float64
    for name in LENS_FIELDS:
        np.testing.assert_array_equal(getattr(lens, name).numpy(), np.asarray(getattr(jl, name)))
    assert prescription_from_numpy(jl).curvatures.dtype == torch.float32
    assert torch.equal(prescription_from_numpy(jl).curvatures, reference_prescription().curvatures)
    assert lens.curvatures[1].item() == 1 / -89.350  # not the float32 rounding


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fresnel_matches_jax(dtype):
    """Limits (normal incidence, grazing, total internal reflection) and a grid of angles and media."""
    cos = np.concatenate([np.linspace(-1.0, 1.0, 201), [0.0, 1e-3, 1.0, -1.0]]).astype(np_dtype(dtype))
    media = [(1.0, 1.5), (1.5, 1.0), (1.0, 1.652), (1.6396, 1.0), (1.5776, 1.68990), (1.7040, 1.5930)]
    tol = 1e-12 if dtype == torch.float64 else F32["lane"]
    with precision(dtype):
        for n1, n2 in media:
            want = np.asarray(j_real.fresnel_dielectric(jnp.asarray(cos), n1, n2))
            got = realistic.fresnel_dielectric(torch.as_tensor(cos), n1, n2).numpy()
            assert got.dtype == cos.dtype
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    r = realistic.fresnel_dielectric(torch.tensor([1.0, 0.001], dtype=dtype), 1.0, 1.5)
    assert abs(r[0].item() - ((1 - 1.5) / (1 + 1.5)) ** 2) <= 1e-6 and r[1].item() > 0.95
    tir = realistic.fresnel_dielectric(torch.tensor(np.linspace(0.0, 0.7, 50), dtype=dtype), 1.5, 1.0)
    assert (tir == 1.0).all()  # cos < sqrt(1 - 1/1.5^2) = 0.745: all past the critical angle


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_intersect_and_refract_match_jax(dtype):
    """Lane by lane at scalar surfaces (curved, planar, negative radius) and at (G, 1) surfaces, both directions."""
    rng = np.random.default_rng(1)
    n = 256
    o = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n), rng.uniform(-3, 3, n)], -1)
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) * np.where(np.arange(n) % 4 == 0, -1, 1)
    d[:8, 2] = 0.0  # parallel to a plane
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np_dtype(dtype)), d.astype(np_dtype(dtype))
    tol = 1e-12 if dtype == torch.float64 else F32["lane"]
    zc = np.array([[2.0, 1 / 30.81], [4.0, 1 / -89.35], [5.0, 0.0], [0.5, 1 / 580.38]], np_dtype(dtype))
    with precision(dtype):
        cases = [(o, d, jnp.asarray(z), jnp.asarray(c), torch.tensor(z), torch.tensor(c)) for z, c in zc]
        og, dg = np.broadcast_to(o, (4,) + o.shape), np.broadcast_to(d, (4,) + d.shape)
        cases.append((og, dg, jnp.asarray(zc[:, :1]), jnp.asarray(zc[:, 1:]),
                      torch.as_tensor(zc[:, :1]), torch.as_tensor(zc[:, 1:])))
        for oo, dd, jz, jc, tz, tc in cases:
            jt, jn, jok = j_real._intersect_surface(jnp.asarray(oo), jnp.asarray(dd), jz, jc)
            t, nrm, ok = realistic._intersect_surface(torch.as_tensor(oo), torch.as_tensor(dd), tz, tc)
            assert torch.equal(ok, torch.as_tensor(np.asarray(jok))) and ok.any() and not ok.all()
            np.testing.assert_allclose(t.numpy()[ok], np.asarray(jt)[ok], rtol=tol, atol=tol)
            np.testing.assert_allclose(nrm.numpy()[ok], np.asarray(jn)[ok], rtol=tol, atol=tol * 100)
            for eta in (1 / 1.652, 1.652, 1.5776 / 1.0):
                jd, jv = j_real._refract(jnp.asarray(dd), jn, jnp.full(jt.shape, eta, jt.dtype))
                td, tv = realistic._refract(torch.as_tensor(dd), torch.as_tensor(np.asarray(jn)),
                                            torch.full(t.shape, eta, dtype=dtype))
                assert torch.equal(tv, torch.as_tensor(np.asarray(jv)))
                assert tv.all() == (eta < 1)  # past the critical angle where eta > 1
                np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol * 100)
            np.testing.assert_allclose(realistic._reflect(torch.as_tensor(dd), nrm).numpy()[ok],
                                       np.asarray(j_real._reflect(jnp.asarray(dd), jn))[ok], rtol=tol, atol=tol * 100)


def _compare_trace(got, want, dtype):
    live = np.asarray(want.energy) > 0
    assert np.array_equal(got.energy.numpy() > 0, live)
    if dtype == torch.float64:
        np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got.xy.numpy()[live], np.asarray(want.xy)[live], rtol=1e-12, atol=1e-10)
    else:
        rtol, atol = F32["trace_energy"]
        np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy), rtol=rtol, atol=atol)
        rtol, atol = F32["trace_xy"]
        np.testing.assert_allclose(got.xy.numpy()[live], np.asarray(want.xy)[live], rtol=rtol, atol=atol)
    return int(live.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_trace_ghost_stack_matches_jax(dtype):
    """All 13 pairs x 3 wavelengths, unrolled and batched, on rays that fill and overfill the pupil."""
    o, d = random_rays(64, 0, dtype)
    with precision(dtype):
        jl, lens = lenses(dtype)
        n_live = 0
        for pair in PAIRS:
            for c in range(3):
                want = j_real.trace_ghost_stack(jl, jnp.asarray(o), jnp.asarray(d), c, pair)
                n_live += _compare_trace(realistic.trace_ghost_stack(lens, torch.as_tensor(o), torch.as_tensor(d), c, pair),
                                         want, dtype)
        surf, kind, bwd = (np.repeat(a, 3, axis=0) for a in realistic.build_event_table(PAIRS, 9, 5))
        assert all(np.array_equal(a, np.repeat(b, 3, axis=0))
                   for a, b in zip((surf, kind, bwd), j_real.build_event_table(PAIRS, 9, 5)))
        assert surf.shape == (39, 17) and set((kind != realistic._EV_NOOP).sum(axis=1)) <= set(range(11, 18))
        colors = np.tile(np.arange(3), len(PAIRS)).astype(np.int32)
        og, dg = np.broadcast_to(o, (39,) + o.shape), np.broadcast_to(d, (39,) + d.shape)
        want = j_real.trace_ghosts_batched(jl, jnp.asarray(og), jnp.asarray(dg), jnp.asarray(colors),
                                           jnp.asarray(surf), jnp.asarray(kind), jnp.asarray(bwd))
        got = realistic.trace_ghosts_batched(lens, torch.as_tensor(og), torch.as_tensor(dg), colors, surf, kind, bwd)
        n_live += _compare_trace(got, want, dtype)
    assert n_live > 1000


def test_batched_trace_matches_unrolled():
    """The port's event-table trace equals its per-pair trace, at the JAX test's tolerances (``test_lens.py:319``)."""
    lens = reference_prescription()
    o, d = (torch.as_tensor(a) for a in random_rays(64, 0, torch.float32))
    surf, kind, bwd = (np.repeat(a, 3, axis=0) for a in realistic.build_event_table(PAIRS, 9, 5))
    colors = np.tile(np.arange(3), len(PAIRS))
    tr = realistic.trace_ghosts_batched(lens, o.expand(39, -1, -1), d.expand(39, -1, -1), colors, surf, kind, bwd)
    n_live = 0
    for gi, (pair, color) in enumerate((p, c) for p in PAIRS for c in range(3)):
        ref = realistic.trace_ghost_stack(lens, o, d, color, pair)
        np.testing.assert_allclose(tr.energy[gi].numpy(), ref.energy.numpy(), rtol=2e-5, atol=1e-6)
        live = ref.energy.numpy() > 0
        n_live += int(live.sum())
        np.testing.assert_allclose(tr.xy[gi].numpy()[live], ref.xy.numpy()[live], rtol=1e-3, atol=1e-3)
    assert n_live > 500


def test_lens_stack_axial_ray_and_vignetting():
    """An axial ray through pair (0, 1) stays on the axis with two reflections' energy; one outside every element is clipped."""
    lens = reference_prescription()
    tr = realistic.trace_ghost_stack(lens, torch.tensor([[0.0, 0.0, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]]), 1, (0, 1))
    assert tr.xy.abs().max() <= 1e-4 and 0.0 < tr.energy.item() < 0.05
    tr = realistic.trace_ghost_stack(lens, torch.tensor([[30.0, 0.0, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]]), 0, (0, 1))
    assert tr.energy.item() == 0.0


def _stack_out(lens, i, j, c):
    """(h, theta) -> the sensor height of the stack's meridional ray through pair (i, j)."""

    def f(v):
        h, th = v[0], v[1]
        o = torch.stack([h - torch.tan(th), 0.0 * h, -1.0 + 0.0 * h])[None]
        d = torch.stack([torch.sin(th), 0.0 * th, torch.cos(th)])[None]
        return realistic.trace_ghost_stack(lens, o, d, c, (i, j)).xy[0, 0]

    return f


def test_physical_ghost_matrix_matches_jax_and_the_stacks_jacobian():
    """The non-circular check of ``test_lens.py:393``: d(stack)/d(h, theta) at 0 equals the matrix, 13 pairs x 3 wavelengths."""
    with precision(torch.float64):
        jl, lens = lenses(torch.float64)
        for i, j in PAIRS:
            for c in range(3):
                m = paraxial.physical_ghost_matrix(lens, i, j, c)
                np.testing.assert_allclose(m.numpy(), np.asarray(j_par.physical_ghost_matrix(jl, i, j, c)),
                                           rtol=1e-12, atol=1e-15)
                jac = torch.autograd.functional.jacobian(_stack_out(lens, i, j, c), torch.zeros(2, dtype=torch.float64))
                np.testing.assert_allclose(jac.numpy(), m[0].numpy(), rtol=1e-8, atol=1e-10,
                                           err_msg=f"pair {(i, j)} color {c}")
    m32 = paraxial.physical_ghost_matrix(reference_prescription(), 2, 4, 1)
    assert m32.dtype == torch.float32 and torch.allclose(m32.double(), paraxial.physical_ghost_matrix(lens, 2, 4, 1), rtol=1e-5)


def test_small_angle_convergence_order():
    """The aberration residual against the linear model shrinks by >= 3.5x per halving (``test_lens.py:431``)."""
    lens = reference_prescription(dtype=torch.float64)
    for i, j in [(1, 4), (2, 4), (6, 8)]:
        m = paraxial.physical_ghost_matrix(lens, i, j, 0).numpy()
        f = _stack_out(lens, i, j, 0)
        errs = []
        for s in (1.0, 0.5, 0.25):
            h, th = 0.8 * s, 0.02 * s
            errs.append(abs(f(torch.tensor([h, th], dtype=torch.float64)).item() - (m[0, 0] * h + m[0, 1] * th)))
        assert errs[0] > errs[1] > errs[2] > 0, (i, j, errs)
        assert errs[0] / errs[1] > 3.5 and errs[1] / errs[2] > 3.5, (i, j, errs)


def test_reference_paraxial_quirk():
    """``trace_ghost`` (reference parity) equals the physical chain where the backward segment crosses no curved surface
    and differs elsewhere (``test_lens.py:467``)."""
    lens = reference_prescription(dtype=torch.float64)
    T, R, L = paraxial.build_matrices(lens)

    def ref_linear(i, j):
        e = 1e-7
        r_in = torch.tensor([e, 0.0], dtype=torch.float64)
        ii, jj = torch.tensor([i]), torch.tensor([j])
        ra = paraxial.trace_ghost(lens, T, R, L, ii, jj, r_in[:1], torch.tensor(0.0, dtype=torch.float64))
        rb = paraxial.trace_ghost(lens, T, R, L, ii, jj, r_in[1:], torch.tensor(e, dtype=torch.float64))
        return np.array([ra[0, 0, 0].item() / e, rb[0, 0, 0].item() / e])

    for i, j in [(0, 1), (1, 2), (3, 4), (6, 7), (7, 8)]:
        np.testing.assert_allclose(ref_linear(i, j), paraxial.physical_ghost_matrix(lens, i, j, 0)[0].numpy(), rtol=1e-5)
    for i, j in [(1, 4), (2, 4), (6, 8)]:
        assert not np.allclose(ref_linear(i, j), paraxial.physical_ghost_matrix(lens, i, j, 0)[0].numpy(), rtol=1e-3)


def _render(module, lens, dtype, axis=AXIS, width=48, height=40, **kw):
    xp = jnp if module is j_real else torch
    cast = (lambda a: jnp.asarray(a, np_dtype(dtype))) if xp is jnp else (lambda a: torch.tensor(a, dtype=dtype))
    return module.render_ghosts_stack(lens, cast(0.3), cast(RADIANCE), cast(axis), width, height, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["all_pairs", "subset", "sun_at_half_width", "sun_near_corner"])
def test_render_ghosts_stack_matches_jax(case, dtype):
    """``sun_near_corner`` puts most taps off the film: the port clamps them before the integer cast, JAX does not."""
    kw = dict(pupil_samples=12)
    if case == "subset":
        kw["pairs"] = SUBSET
    # atan(+-inf) at half width: the pattern turns a quarter
    axis = {"sun_at_half_width": (0.5, 0.55), "sun_near_corner": (0.04, 0.93)}.get(case, AXIS)
    with precision(dtype):
        jl, lens = lenses(dtype)
        want = np.asarray(_render(j_real, jl, dtype, axis=axis, **kw))
        got = _render(realistic, lens, dtype, axis=axis, **kw)
    assert got.dtype == dtype and got.shape == (40, 48, 3) and torch.isfinite(got).all() and got.sum() > 0
    close_to_peak(got.numpy(), want, 1e-12 if dtype == torch.float64 else F32["image"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "large_beside_small"])
def test_ordered_sum_matches_index_add(case, dtype):
    """The ghost buffer's fixed-order sum against float64 ``index_add`` (one add after another on the CPU).

    ``large_beside_small``: pixel 3 gets taps of 1e8, pixel 4 taps of 1e-3; a prefix sum over every tap
    differenced at the runs' ends would lose pixel 4 against pixel 3's prefix."""
    rng = np.random.default_rng(5)
    if case == "random":
        idx = rng.integers(0, 700, 5000)
        vals = rng.uniform(0.0, 2.0, 5000)
    else:
        idx = rng.permutation(np.repeat([3, 4, 9], [50, 200, 1]))
        vals = np.where(idx == 3, 1e8, np.where(idx == 4, 1e-3, 0.5))
    idx, vals = torch.as_tensor(idx), torch.as_tensor(vals, dtype=dtype).requires_grad_(True)
    got = realistic.ordered_sum(idx, vals, 701)
    # float64 index_add of the same taps: in float32 it is the reference's sum, closer than float32's own
    want = torch.zeros(701, dtype=torch.float64).index_add(0, idx, vals.detach().double())
    rtol = 1e-6 if dtype == torch.float32 else 1e-14
    np.testing.assert_allclose(got.detach().double().numpy(), want.numpy(), rtol=rtol, atol=0)
    assert got.dtype == dtype and (got[torch.bincount(idx, minlength=701) == 0] == 0).all()
    cot = torch.as_tensor(rng.uniform(size=701), dtype=dtype)
    (grad,) = torch.autograd.grad((got * cot).sum(), vals)
    assert torch.equal(grad, cot[idx])


def test_default_render_has_energy():
    """JAX's defaults (32x32 pupil, 740 rays in the disc, all 13 pairs) on a 64x64 film (``test_lens.py:110``)."""
    img = realistic.render_ghosts_stack(reference_prescription(), 0.3, torch.tensor(RADIANCE), torch.tensor(AXIS), 64, 64)
    lin = np.linspace(-1, 1, 32)
    assert int(((lin[:, None] ** 2 + lin[None] ** 2) <= 1).sum()) == 740
    assert img.shape == (64, 64, 3) and torch.isfinite(img).all() and img.sum() > 0


@pytest.fixture(scope="module")
def grad_case():
    """The float64 stack's loss and gradient in every float field, the JAX package's (``test_lens.py:248``)."""
    w = h = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    window = np.exp(-(((xx - 14.0) ** 2 + (yy - 20.0) ** 2) / 120.0))
    with precision(torch.float64):
        jl, _ = lenses(torch.float64)

        def j_loss(lens):
            img = j_real.render_ghosts_stack(lens, jnp.float64(0.3), jnp.asarray(RADIANCE), jnp.asarray(AXIS), w, h,
                                             pupil_samples=8, pairs=SUBSET)
            return jnp.sum(img * jnp.asarray(window)[:, :, None])

        j_grad = jax.grad(j_loss)(jl)
        want = {name: np.asarray(getattr(j_grad, name)) for name in LENS_FIELDS}
        loss = float(j_loss(jl))

    def t_loss(lens):
        img = realistic.render_ghosts_stack(lens, torch.tensor(0.3, dtype=torch.float64), torch.tensor(RADIANCE, dtype=torch.float64),
                                            torch.tensor(AXIS, dtype=torch.float64), w, h, pupil_samples=8, pairs=SUBSET)
        return (img * torch.as_tensor(window)[:, :, None]).sum()

    return jl, t_loss, loss, want


@pytest.mark.parametrize("field", LENS_FIELDS)
def test_render_gradient_matches_jax(field, grad_case):
    jl, t_loss, loss, want = grad_case
    lens = prescription_from_numpy(jl, dtype=torch.float64)
    leaf = getattr(lens, field).clone().requires_grad_(True)
    setattr(lens, field, leaf)
    value = t_loss(lens)
    assert abs(value.item() - loss) <= 1e-12 * abs(loss)
    if field == "aperture_height":  # the iris clips by a step: no gradient in either package
        assert not want[field].any() and not value.requires_grad
        return
    (grad,) = torch.autograd.grad(value, leaf)
    assert torch.isfinite(grad).all()
    close_to_peak(grad.numpy(), want[field], 1e-9)


def test_render_gradient_matches_central_differences(grad_case):
    jl, t_loss, _, _ = grad_case
    checked = 0
    for field in ("spacings", "curvatures"):
        lens = prescription_from_numpy(jl, dtype=torch.float64)
        base = getattr(lens, field)
        leaf = base.clone().requires_grad_(True)
        setattr(lens, field, leaf)
        t_loss(lens).backward()
        for idx in range(0, len(base), 4):
            eps = 1e-6 * max(abs(base[idx].item()), 1.0)
            vals = []
            for sign in (1, -1):
                moved = base.clone()
                moved[idx] += sign * eps
                setattr(lens, field, moved)
                vals.append(t_loss(lens).item())
            fd, an = (vals[0] - vals[1]) / (2 * eps), leaf.grad[idx].item()
            assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-3), (field, idx, fd, an)
            checked += 1
    assert checked >= 5


def test_gradient_is_finite_on_vignetted_lanes():
    """Lanes past the elements, the iris and total internal reflection: a masked branch must not give NaN."""
    lens = reference_prescription(dtype=torch.float64)
    lens.curvatures = lens.curvatures.clone().requires_grad_(True)
    lens.spacings = lens.spacings.clone().requires_grad_(True)
    o, d = (torch.as_tensor(a) for a in random_rays(256, 3, torch.float64, angle=0.6))
    o = o * 2.5  # most lanes miss an element or are clipped by the iris
    total = 0.0
    dead = 0
    for pair in PAIRS:
        tr = realistic.trace_ghost_stack(lens, o, d, 2, pair)
        total = total + (tr.energy * (tr.xy**2).sum(-1)).sum() + tr.energy.sum()
        dead += int((tr.energy == 0).sum())
    total.backward()
    assert dead > 13 * 128 and torch.isfinite(lens.curvatures.grad).all() and torch.isfinite(lens.spacings.grad).all()
    assert lens.curvatures.grad.abs().sum() > 0


def test_adam_recovers_curvature_7():
    """Lens design through the stack on the CPU (``test_lens.py:509``): 150 Adam steps from curvature 7 x 1.25."""
    pairs = SUBSET
    lens_true = reference_prescription()

    def img_of(lens):
        return realistic.render_ghosts_stack(lens, 0.3, torch.ones(3), torch.tensor(AXIS), 64, 64,
                                             pupil_samples=12, pairs=pairs)

    target = img_of(lens_true)
    c_true = lens_true.curvatures[7].item()
    c0 = lens_true.curvatures.clone()
    c0[7] *= 1.25
    curv = c0.clone().requires_grad_(True)
    mask = torch.zeros_like(curv)
    mask[7] = 1.0
    opt = torch.optim.Adam([curv], lr=2e-4)

    def loss_fn(c):
        lens = reference_prescription()
        lens.curvatures = c
        return ((img_of(lens) - target) ** 2).mean() * 1e6

    with torch.no_grad():
        loss0 = loss_fn(curv).item()
    for _ in range(150):
        opt.zero_grad()
        loss = loss_fn(curv)
        loss.backward()
        curv.grad *= mask
        opt.step()
    assert loss.item() < 1e-3 * loss0, (loss.item(), loss0)
    assert abs(curv[7].item() - c_true) <= 0.05 * abs(c0[7].item() - c_true)
    assert torch.equal(curv.detach()[mask == 0], c0[mask == 0])


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    return chip_smoke.terrain_dae(8).write(tmp_path_factory.mktemp("real") / "terrain.dae")


def _pipelines(terrain, w, h, **kw):
    r = Renderer(device="cpu", width=w, height=h, **kw)
    r.load(terrain)
    j = JaxRenderer(width=w, height=h, use_pallas=False, **kw)
    j.load(terrain)
    return r.flare_pipeline(), JaxPipeline.from_renderer(j)


@pytest.mark.parametrize("case", ["realistic", "realistic_aperture", "paraxial_exact", "paraxial_fast"])
def test_flare_pipeline_matches_jax(case, terrain, tmp_path):
    """The pipeline on terrain 8's file, whose sun is on screen: its ghost buffer and its composite, strictly additive.

    ``realistic`` has no aperture (the stack needs none), ``realistic_aperture``
    adds the starburst as BASELINE config 3 does, and the paraxial cases keep
    their ghost texture and both splats.
    """
    from lens_flare_tpu_torch.lens.aperture import polygon_mask
    from lens_flare_tpu_torch.utils.image import save_png

    w, h = 48, 40
    save_png(tmp_path / "ap.png", polygon_mask(24, 5, rotation=0.3))
    save_png(tmp_path / "ghost.png", polygon_mask(16, 6))
    if case.startswith("realistic"):
        kw = dict(lens_model="realistic")
        if case == "realistic_aperture":
            kw.update(aperture_path=str(tmp_path / "ap.png"), flare_intensity=1.5, flare_radius=30.0)
        p, jp = _pipelines(terrain, w, h, **kw)
        assert p is not None and p.lens_model == "realistic" and p.ghost_aperture is None
        assert (p.aperture is None) == (case == "realistic")
        tol = F32["image"]
    else:
        p, jp = _pipelines(terrain, w, h, ghost_aperture_path=str(tmp_path / "ghost.png"))
        assert p.lens_model == "paraxial" and p.ghost_aperture is not None
        p.ghost_method = jp.ghost_method = case.removeprefix("paraxial_")
        # tests/test_torch_flare.py's tolerance for the exact splat; the fast one resamples a 1024^2
        # canonical card by two float32 matrix products, which read 2.6e-4 here: the float32 images'
        tol = 1e-4 if case == "paraxial_exact" else F32["image"]
    assert 0 < p.axis_ray.min() and p.axis_ray.max() < 1
    want = np.asarray(jp.ghost_buffer())
    got = p.ghost_buffer()
    assert got.shape == (h, w, 3) and torch.isfinite(got).all() and got.sum() > 0
    close_to_peak(got.numpy(), want, tol)
    hdr = torch.as_tensor(np.random.default_rng(6).uniform(size=(h, w, 3)).astype(np.float32))
    out = p.composite(hdr)
    assert (out >= hdr).all() and (out > hdr).any()
    close_to_peak(out.numpy(), np.asarray(jp.composite(jnp.asarray(hdr.numpy()))), tol)


@pytest.mark.parametrize("aperture", [False, True], ids=["ghosts_only", "with_aperture"])
def test_cli_realistic_matches_jax(aperture, terrain, tmp_path, capsys):
    """``--lens-model realistic`` through both command lines, alone and with ``-x``/``-i``/``-n`` as BASELINE
    config 3 runs it: the PNGs within one 8-bit level on >= 99% of values."""
    from lens_flare_tpu_torch.lens.aperture import polygon_mask
    from lens_flare_tpu_torch.utils.image import save_png

    w, h = 48, 40
    flags = ["-r", str(w), str(h), "-s", "1", "-m", "1"]
    if aperture:
        save_png(tmp_path / "ap.png", polygon_mask(24, 5, rotation=0.3))
        flags += ["-x", str(tmp_path / "ap.png"), "-i", "1.5", "-n", "30"]
    real = ["--lens-model", "realistic"]
    assert cli.main([*flags, *real, "-f", str(tmp_path / "port.png"), "--device", "cpu", str(terrain)]) == 0
    assert j_cli.main([*flags, *real, "-f", str(tmp_path / "jax.png"), str(terrain)]) == 0
    got, want = load_png(tmp_path / "port.png"), load_png(tmp_path / "jax.png")
    assert got.shape == want.shape == (h, w, 3)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    # the ghosts are in the frame: the paraxial model without a ghost aperture draws none
    assert cli.main([*flags, "-f", str(tmp_path / "plain.png"), "--device", "cpu", str(terrain)]) == 0
    assert np.abs(load_png(tmp_path / "plain.png").astype(np.int64) - got).sum() > 0


@pytest.mark.parametrize("fault", ["energy_5pct", "shifted_1px"])
def test_ghost_checks_catch_a_dim_ghost(fault, monkeypatch):
    """The dimmest ghost pair of the 1080p buffer made 5% too bright, or moved by a pixel: the buffer
    stays within 1e-3 of its peak of the right one, and ``chip_smoke.ghost_errors`` fails it."""
    args = (0.3, RADIANCE, AXIS, 1920, 1080)
    want = chip_smoke.ghost_moments(*args, "cpu", torch.float32)
    dim = min(want, key=lambda k: want[k][0].item())
    pair = tuple(int(v) for v in dim.split(":")[0].split("-"))
    render = realistic.render_ghosts_stack

    def faulty(*a, pairs=None, **kw):
        img = render(*a, pairs=pairs, **kw)
        if pairs is None or [tuple(p) for p in pairs] != [pair]:
            return img
        return img * 1.05 if fault == "energy_5pct" else torch.roll(img, 1, dims=1)

    monkeypatch.setattr(realistic, "render_ghosts_stack", faulty)
    errs = chip_smoke.ghost_errors(chip_smoke.ghost_moments(*args, "cpu", torch.float32), want)
    measure = "energy" if fault == "energy_5pct" else "centroid_px"
    bad = [k for k, v in errs[measure].items() if v > chip_smoke.GHOST_F32[measure]]
    assert bad == [k for k in errs[measure] if k.startswith(dim.split(":")[0] + ":")] and dim in bad
    assert all(v == 0 for m in errs.values() for k, v in m.items() if k not in bad)
    lens, rad, axis = reference_prescription(), torch.tensor(RADIANCE), torch.tensor(AXIS)
    full = render(lens, 0.3, rad, axis, 1920, 1080)
    one = render(lens, 0.3, rad, axis, 1920, 1080, pairs=[pair])
    wrong = full - one + (one * 1.05 if fault == "energy_5pct" else torch.roll(one, 1, dims=1))
    assert (wrong - full).abs().max() / full.abs().max() <= 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sum_grads(dev, dtype):
    """The gradient of the 1080p buffer's sum at JAX's defaults in the spacings, curvatures and indices,
    from float32 inputs (``chip_smoke.float32_lens``) computed in ``dtype``."""
    lens = chip_smoke.float32_lens(dev, dtype)
    leaves = [getattr(lens, f).clone().requires_grad_(True) for f in ("spacings", "curvatures", "iors")]
    lens.spacings, lens.curvatures, lens.iors = leaves
    args = (torch.tensor(v, dtype=torch.float32).to(dev, dtype) for v in (0.3, RADIANCE, AXIS))
    img = realistic.render_ghosts_stack(lens, *args, 1920, 1080)
    return [g.cpu().double() for g in torch.autograd.grad(img.sum(), leaves)]


def _peak_rel(got, want):
    return max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want))


@pytest.mark.gpu
def test_realistic_on_card_matches_cpu(cuda_device):
    """Card against CPU at JAX's defaults on a 1920x1080 film, with float64 as the witness of a fault.

    - the float32 buffer to 1e-3 of its peak, and each ghost's energy,
      centroid and radius (one pair, one channel; ``chip_smoke.ghost_checks``)
      to ``chip_smoke.GHOST_F32``, in float64 to ``GHOST_F64``;
    - the float32 gradient of the central-difference case's windowed loss to
      1e-3 of its peak;
    - the gradient of the whole buffer's sum in float64 to 1e-12 of its
      peak (7.0e-15 on an H100).  In float32 it is no test: the four
      bilinear taps' position terms cancel, and what is left is rounding
      (float32 against the CPU's float64: 1.4e-2 from the CPU, 0.12 from
      the card).  The readings are printed.
    """
    cpu = "cpu"
    imgs, grads = [], []
    w = h = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    window = torch.as_tensor(np.exp(-(((xx - 14.0) ** 2 + (yy - 20.0) ** 2) / 120.0)), dtype=torch.float32)
    for dev in (cpu, cuda_device):
        imgs.append(realistic.render_ghosts_stack(reference_prescription(device=dev), 0.3, torch.tensor(RADIANCE, device=dev),
                                                  torch.tensor(AXIS, device=dev), 1920, 1080).cpu())
        lens = reference_prescription(device=dev)
        leaves = [getattr(lens, f).clone().requires_grad_(True) for f in ("spacings", "curvatures", "iors")]
        lens.spacings, lens.curvatures, lens.iors = leaves
        img = realistic.render_ghosts_stack(lens, 0.3, torch.tensor(RADIANCE, device=dev), torch.tensor(AXIS, device=dev),
                                            w, h, pupil_samples=8, pairs=SUBSET)
        grads.append([g.cpu() for g in torch.autograd.grad((img * window.to(dev)[:, :, None]).sum(), leaves)])
    assert torch.isfinite(imgs[1]).all() and imgs[1].sum() > 0
    close_to_peak(imgs[1].numpy(), imgs[0].numpy(), 1e-3)
    for got, want in zip(grads[1], grads[0]):
        close_to_peak(got.numpy(), want.numpy(), 1e-3)

    worst = chip_smoke.ghost_checks(0.3, RADIANCE, AXIS, 1920, 1080)
    f32, f64 = torch.float32, torch.float64
    sums = {(dev, dt): _sum_grads(dev, dt) for dev in (cpu, cuda_device) for dt in (f32, f64)}
    sum_errs = {
        "card_vs_cpu_f64": _peak_rel(sums[cuda_device, f64], sums[cpu, f64]),
        "card_vs_cpu_f32": _peak_rel(sums[cuda_device, f32], sums[cpu, f32]),
        "card_f32_vs_cpu_f64": _peak_rel(sums[cuda_device, f32], sums[cpu, f64]),
        "cpu_f32_vs_f64": _peak_rel(sums[cpu, f32], sums[cpu, f64]),
    }
    print("[realistic_on_card] ghosts_worst=" + json.dumps(worst) + " sum_grad_peak_rel=" + json.dumps(sum_errs))
    assert sum_errs["card_vs_cpu_f64"] <= 1e-12


@pytest.mark.gpu
def test_ghost_buffer_is_reproducible_on_card(cuda_device):
    """The 1920x1080 buffer and its gradient twice on the card, and the buffer replayed from a captured
    program (``compiled.Programs``) against an eager call: bit for bit."""
    from lens_flare_tpu_torch import compiled

    args = tuple(torch.tensor(v, device=cuda_device) for v in (0.3, RADIANCE, AXIS))
    lens = reference_prescription(device=cuda_device)
    tables = realistic.ghost_stack_tables(lens)

    def buffer(angle, radiance, axis):
        return realistic.render_ghosts_stack(lens, angle, radiance, axis, 1920, 1080, tables=tables)

    runs = [buffer(*args) for _ in range(2)]
    programs = compiled.Programs()
    replays = [programs.run("ghosts", buffer, *args) for _ in range(2)]
    assert len(programs) == 1 and runs[0].sum() > 0
    for other in (runs[1], *replays):
        assert torch.equal(other, runs[0])
    grads = []
    for _ in range(2):
        g_lens = reference_prescription(device=cuda_device)
        g_lens.curvatures = g_lens.curvatures.clone().requires_grad_(True)
        img = realistic.render_ghosts_stack(g_lens, *args, 64, 48, pupil_samples=12, pairs=SUBSET)
        grads.append(torch.autograd.grad(img.square().sum(), g_lens.curvatures)[0])
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().max() > 0
