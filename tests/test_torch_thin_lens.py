"""The thin-lens bokeh adaptive render (BASELINE config 2) against the JAX package.

The JAX reference is ``Renderer(use_pallas=False)`` on the CPU, with the
bokeh mask set on its bundle directly (the octagon is drawn in code: the
repository holds no bokeh PNG).  The port runs on the CPU through the plain
versions of its kernels; on terrain 40 its closest hits take kernel D's.
Both draw the same threefry tape lane for lane.

Tolerances and why (those of ``tests/test_torch_integrator.py``):
- rays, projections and lens points: 1e-6 relative to their magnitude (XLA
  fuses multiply-adds, the port rounds every product; a screen coordinate
  near 0 comes from (x + 1) / 2 with x near -1, so an ulp of x is compared
  against the unit screen range, not against the small result);
- texel indices and the bokeh CDF: equal;
- radiance sums and pixels: >= 99% of lanes within 1e-4 absolute plus 1e-4
  relative, mean relative difference < 1e-3;
- adaptive sample counts equal on >= 99.5% of pixels: a pixel whose CI test
  sits on the threshold may stop one stage apart on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.integrator import path as jpath
from lens_flare_tpu.renderer import Renderer as JaxRenderer
from lens_flare_tpu.scene import camera as jcam
from lens_flare_tpu.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch import _rng
from lens_flare_tpu_torch.convert import bokeh_mask_from_numpy, camera_params_from_numpy
from lens_flare_tpu_torch.integrator import path as tpath
from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene import camera as tcam

W, H = 32, 24
KW = dict(width=W, height=H, ns_aa=8, samples_per_batch=2, max_tolerance=0.05,
          max_ray_depth=4, ns_area_light=1, indirect=True, seed=0)
OCTAGON = polygon_mask(64, 8)


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of lanes within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


@pytest.fixture(scope="module")
def pair():
    """(JAX renderer, port renderer) on terrain 40, thin lens focused at the frame centre."""
    scene = make_terrain_scene(40)
    lens_radius = 0.01 * float(np.linalg.norm(scene.bbox_max - scene.bbox_min))
    jr = JaxRenderer(use_pallas=False, lens_radius=lens_radius, tile_pixels=256, **KW)
    jr.load_flat_scene(scene)
    jr.autofocus(W / 2, H / 2)
    jr.bundle = jr.bundle._replace(bokeh=jpath.BokehMask.from_texture(OCTAGON))
    r = Renderer(device="cpu", lens_radius=lens_radius, bokeh=ApertureTexture.from_array(OCTAGON), **KW)
    r.load_flat_scene(make_terrain_scene(40))
    return jr, r


def test_autofocus(pair):
    jr, r = pair
    assert r.bundle.cscene.shade  # the centre ray goes through kernel D's plain version
    got = r.autofocus(W / 2, H / 2)
    np.testing.assert_allclose(got, jr.focal_distance, rtol=1e-6)
    assert 0 < got < 1e30 and r.camera.focal_distance == got
    r.autofocus(W / 2, H / 2)
    r.focal_distance = r.camera.focal_distance = jr.focal_distance  # identical inputs below


def test_lens_rays_and_projection(pair):
    jr, _ = pair
    jp = jr.camera.params()
    p = camera_params_from_numpy(jp)
    assert float(p.lens_radius) > 0 and float(p.focal_distance) > 0
    rng = np.random.default_rng(0)
    x, y, u, v = rng.uniform(0, 1, (4, 512)).astype(np.float32)
    uv = rng.uniform(-0.5, 0.5, (512, 2)).astype(np.float32)
    t = torch.from_numpy
    for got, want in (
        (tcam.generate_rays_thin_lens(p, t(x), t(y), t(u), t(v)),
         jcam.generate_rays_thin_lens(jp, x, y, u, v)),
        (tcam.generate_rays_bokeh(p, t(x), t(y), t(uv)), jcam.generate_rays_bokeh(jp, x, y, uv)),
    ):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    pts = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
    for g, w in zip(tcam.project_world_to_screen(p, t(pts)), jcam.project_world_to_screen(jp, pts)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_bokeh_sample():
    jm = jpath.BokehMask.from_texture(OCTAGON)
    tm = tpath.BokehMask.from_texture(OCTAGON)
    assert (tm.width, tm.height) == (jm.width, jm.height)
    assert np.array_equal(tm.cdf.numpy(), np.asarray(jm.cdf))
    assert np.array_equal(bokeh_mask_from_numpy(jm).cdf.numpy(), tm.cdf.numpy())
    rng = np.random.default_rng(1)
    u, jit = rng.uniform(0, 1, (2, 4096)).astype(np.float32)
    u[:4] = [0.0, 1.0, np.asarray(jm.cdf)[100], np.nextafter(np.float32(1.0), 0)]
    idx_t = torch.searchsorted(tm.cdf, torch.from_numpy(u), right=True).numpy()
    idx_j = np.asarray(jnp.searchsorted(jm.cdf, u, side="right"))
    assert np.array_equal(idx_t, idx_j)
    for jitter in (None, jit):
        got = tm.sample(torch.from_numpy(u), None if jitter is None else torch.from_numpy(jitter))
        want = jm.sample(jnp.asarray(u), None if jitter is None else jnp.asarray(jitter))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_render_batch(pair):
    """Samples 2-3 of every pixel, per lane, on the bokeh thin-lens camera."""
    jr, r = pair
    i = np.arange(W * H)
    px, py = (i % W).astype(np.int32), (i // W).astype(np.int32)
    want = jpath.render_batch(
        jr.bundle, jr.settings, jr.camera.params(), jnp.asarray(px), jnp.asarray(py), W, H,
        jax.random.PRNGKey(0), jnp.uint32(2), 2,
    )
    cam = camera_params_from_numpy(jr.camera.params())
    got = tpath.render_batch(
        r.bundle, r.settings, cam, torch.as_tensor(px), torch.as_tensor(py), W, H,
        _rng.prng_key(0), 2, 2,
    )
    assert r.settings.use_thin_lens and r.bundle.bokeh is not None
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy()[[0, 2]], np.asarray(want[3])[[0, 2]], rtol=5e-3)


def test_adaptive_render_matches_jax(pair):
    jr, r = pair
    want, want_counts = jr.render(progress=False)
    got, counts = r.render(progress=False)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    counts = counts.numpy()
    assert set(np.unique(counts)) <= {2, 4, 8}
    assert (counts == np.asarray(want_counts)).mean() >= 0.995
    _close(got.numpy().reshape(-1, 3), np.asarray(want).reshape(-1, 3))
    # stages of 2, 2 and 4 samples: the pixels left after each stage
    a1, a2, _ = r.stats.active_per_stage
    assert [(counts == c).sum() for c in (2, 4, 8)] == [W * H - a1, a1 - a2, a2]
    assert r.stats.total_rays > 0
    a, b = r.stats.total_rays, jr.stats.total_rays
    assert abs(a - b) <= 5e-3 * b, (a, b)
