"""The port's integrator against the JAX package's, stage by stage.

The JAX reference is ``Renderer(use_pallas=False)`` on the CPU (its XLA
binary-BVH trace); its scene tables are carried across by ``convert.py``,
and the port traces through the plain versions of kernels A, B and C over
the wide cluster tree.  Both draw the same threefry tape lane for lane, so
the comparison is per lane, not statistical.

Tolerances and why: the two sides round differently in the last bits
(XLA:CPU fuses multiply-adds and orders small reductions its own way; the
port rounds every product), so
- rays and directions: 1e-6 relative to their magnitude;
- normals: 1e-5; radiance samples and pixels: >= 99% within 1e-4 absolute
  plus 1e-4 relative, mean relative difference < 1e-3 (a rare grazing ray
  may hit on one side only and change its pixel);
- rays_traced and zero_rays_skipped within 0.5% (the primitive-test
  counts differ by design: the JAX reference walks a binary SAH BVH).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.accel.wide import build_wide_bvh
from lens_flare_tpu.integrator import path as jpath
from lens_flare_tpu.ops.intersect import finalize_hit as j_finalize_hit
from lens_flare_tpu.renderer import Renderer as JaxRenderer
from lens_flare_tpu.scene.camera import generate_rays as j_generate_rays
from lens_flare_tpu.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch import _rng
from lens_flare_tpu_torch.accel.wide import MAX_TRIS, check_capacity, takes_wide_tree
from lens_flare_tpu_torch.convert import (
    camera_params_from_numpy,
    cuda_scene_from_wide_bvh,
    scene_bundle_from_numpy,
)
from lens_flare_tpu_torch.integrator import path as tpath
from lens_flare_tpu_torch.ops.intersect import finalize_hit
from lens_flare_tpu_torch.ops.intersect_cuda import intersect
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.camera import generate_rays

W, H = 32, 24
KW = dict(width=W, height=H, ns_aa=2, max_ray_depth=4, ns_area_light=1, indirect=True, seed=0)


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of lanes within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


@pytest.fixture(scope="module", params=[8, 40], ids=["terrain8", "terrain40"])
def pair(request):
    scene = make_terrain_scene(request.param)
    jr = JaxRenderer(use_pallas=False, **KW)
    jr.load_flat_scene(scene)
    cs = cuda_scene_from_wide_bvh(
        build_wide_bvh(scene.tri_p), scene.sph_center, scene.sph_radius, scene.num_triangles
    )
    bundle = scene_bundle_from_numpy(jr.bundle.scene, jr.bundle.bsdfs, jr.bundle.lights, cs)
    settings = tpath.make_settings(
        scene.lights, bsdf_table=scene.bsdfs, ns_aa=2, max_ray_depth=4, ns_area_light=1
    )
    cam = camera_params_from_numpy(jr.camera.params())
    return scene, jr, bundle, settings, cam


def _pixels(n=W * H):
    i = np.arange(n)
    return (i % W).astype(np.int32), (i // W).astype(np.int32)


def _keys(px, py, sample=0):
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(0), (py * W + px).astype(np.uint32)
    )
    jk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, np.uint32(sample))
    tk = _rng.fold_in(tpath.pixel_keys(_rng.prng_key(0), torch.as_tensor(px), torch.as_tensor(py), W), sample)
    assert (np.asarray(jk).astype(np.int64) == tk.numpy()).all()
    return jk, tk


def test_generate_rays(pair):
    _, jr, _, _, cam = pair
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 1, (2, 512)).astype(np.float32)
    jo, jd = j_generate_rays(jr.camera.params(), jnp.asarray(x), jnp.asarray(y))
    o, d = generate_rays(cam, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_finalize_hit(pair):
    """Same raw hits in: same normals and bsdf rows out."""
    _, jr, bundle, _, cam = pair
    rng = np.random.default_rng(1)
    x, y = rng.uniform(0, 1, (2, 512)).astype(np.float32)
    o, d = generate_rays(cam, torch.from_numpy(x), torch.from_numpy(y))
    n = o.shape[0]
    raw = intersect(bundle.cscene, o.contiguous(), d, torch.full((n,), 1e-3), torch.full((n,), 1e30))
    t, prim, b1, b2, found, _ = raw
    assert found.sum() > 100
    got = finalize_hit(bundle.scene, o, d, t, prim, b1, b2, found)
    want = j_finalize_hit(jr.bundle.scene, *(jnp.asarray(a.numpy()) for a in (o, d, t, prim, b1, b2, found)))
    assert (got.bsdf.numpy() == np.asarray(want.bsdf)).all()
    sel = found.numpy()
    np.testing.assert_allclose(got.n.numpy()[sel], np.asarray(want.n)[sel], atol=1e-5)


def test_direct_lighting(pair):
    """NEE at the primary hits, same tape, same shadow queries."""
    _, jr, bundle, settings, cam = pair
    px, py = _pixels()
    jk, tk = _keys(px, py)
    tape = _rng.uniform(tk, (tpath.tape_size(settings),))
    x = (torch.as_tensor(px).float() + tape[:, 0]) / W
    y = (torch.as_tensor(py).float() + tape[:, 1]) / H
    o, d = generate_rays(cam, x, y)
    n = o.shape[0]
    hit, _ = tpath.trace_closest(bundle, o.contiguous(), d, torch.full((n,), 1e-3), torch.full((n,), 1e30))
    hit_p = o + d * torch.where(hit.hit, hit.t, 0.0)[:, None]
    active = tpath._nee_active(bundle, hit.bsdf, hit.hit)
    s = settings.total_light_samples
    u = tape[:, 4 : 4 + 2 * s]
    L, st = tpath.direct_lighting(bundle, settings, u, hit_p, hit.n, -d, hit.bsdf, active=active)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jL, jst = jpath.direct_lighting(
        jr.bundle, jr.settings, j(u), j(hit_p), j(hit.n), j(-d), j(hit.bsdf), active=j(active)
    )
    _close(L.numpy(), np.asarray(jL))
    np.testing.assert_allclose(st.numpy()[[0, 2]], np.asarray(jst)[[0, 2]], rtol=5e-3)


def test_radiance_sample(pair):
    _, jr, bundle, settings, cam = pair
    px, py = _pixels()
    jk, tk = _keys(px, py, sample=1)
    L, st = tpath.radiance_sample(bundle, settings, cam, tk, torch.as_tensor(px), torch.as_tensor(py), W, H)
    jL, jst = jpath.radiance_sample(
        jr.bundle, jr.settings, jr.camera.params(), jk, jnp.asarray(px), jnp.asarray(py), W, H
    )
    _close(L.numpy(), np.asarray(jL))
    np.testing.assert_allclose(st.numpy()[[0, 2]], np.asarray(jst)[[0, 2]], rtol=5e-3)


def test_render_matches_jax(pair):
    scene, jr, _, _, _ = pair
    want, want_counts = jr.render(progress=False)
    r = Renderer(device="cpu", **KW)
    r.load_flat_scene(scene)
    got, counts = r.render(progress=False)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert (counts.numpy() == np.asarray(want_counts)).all()
    _close(got.numpy().reshape(-1, 3), np.asarray(want).reshape(-1, 3))
    for name in ("total_rays", "total_zero_skipped"):
        a, b = getattr(r.stats, name), getattr(jr.stats, name)
        assert abs(a - b) <= 5e-3 * max(b, 1), (name, a, b)
    assert r.stats.total_rays > 0 and r.stats.total_isects > 0


def test_render_many_spheres_matches_jax():
    """More than the Pallas kernel's 64 spheres: the port renders them, as the JAX Renderer's XLA path does.

    Terrain 8 (128 triangles: kernel C's plain version for the shadow rays)
    with 65 spheres, at ``test_render_matches_jax``'s film and samples but
    depth 2, held to its tolerances (``_close``), pixel counts and stats.
    """
    rng = np.random.default_rng(3)
    n_sph = 65
    scene = make_terrain_scene(8)
    scene.sph_center = rng.uniform(-8, 8, (n_sph, 3)).astype(np.float32)
    scene.sph_center[:, 2] = rng.uniform(1, 3, n_sph)
    scene.sph_radius = rng.uniform(0.3, 1.0, n_sph).astype(np.float32)
    scene.sph_bsdf = np.zeros(n_sph, np.int32)
    kw = dict(KW, max_ray_depth=2)
    jr = JaxRenderer(use_pallas=False, **kw)
    jr.load_flat_scene(scene)
    want, want_counts = jr.render(progress=False)
    r = Renderer(device="cpu", **kw)
    r.load_flat_scene(scene)
    assert r.bundle.cscene.n_spheres == n_sph and r.bundle.cscene.brute
    got, counts = r.render(progress=False)
    assert (counts.numpy() == np.asarray(want_counts)).all()
    _close(got.numpy().reshape(-1, 3), np.asarray(want).reshape(-1, 3))
    for name in ("total_rays", "total_zero_skipped"):
        a, b = getattr(r.stats, name), getattr(jr.stats, name)
        assert abs(a - b) <= 5e-3 * max(b, 1), (name, a, b)
    # some primary rays end on a sphere
    o, d = generate_rays(camera_params_from_numpy(jr.camera.params()),
                         *(torch.as_tensor(rng.uniform(0, 1, 256), dtype=torch.float32) for _ in range(2)))
    hits = intersect(r.bundle.cscene, o.contiguous(), d, torch.full((256,), 1e-3), torch.full((256,), 1e30))
    assert (hits[1] >= scene.num_triangles).any()


def test_triangle_limit_is_named():
    """Past 512*128*256 triangles a scene routes to kernel G's binary BVH; up to it, to the cluster tree.

    The decision is the renderer's first step, taken before any build, so
    a stand-in scene of 16,777,217 triangles checks it without building one.
    """
    assert MAX_TRIS == 16_777_216
    assert takes_wide_tree(16_777_216) and not takes_wide_tree(16_777_217)
    assert not takes_wide_tree(128, use_wide_tree=False) and takes_wide_tree(128, use_wide_tree=True)
    check_capacity(16_777_216)
    with pytest.raises(ValueError, match=r"16,777,217 triangles.*16,777,216.*kernel G"):
        check_capacity(16_777_217)
    with pytest.raises(ValueError, match="kernel G"):
        takes_wide_tree(16_777_217, use_wide_tree=True)
    r = Renderer(device="cpu", use_wide_tree=True, **KW)
    r.scene = SimpleNamespace(num_triangles=16_777_217)  # what _build reads first
    with pytest.raises(ValueError, match="kernel G"):
        r._build()


def test_unported_features_raise(tmp_path, capsys):
    """The name is from when the port refused features it lacked.  The last flags it refused, the CLI's
    --devices and -t above 1 (ROADMAP Queue 1 item 9), now render on the devices that exist (one CPU
    here; tests/test_torch_parallel.py shards over stand-ins).  --upsample and --view:
    tests/test_torch_cli.py."""
    from lens_flare_tpu_torch import cli
    from lens_flare_tpu_torch.scene.writer import cornell_box

    dae = cornell_box().write(tmp_path / "cornell.dae")
    for flags in (["--devices", "2"], ["-t", "2"]):
        assert cli.main(["--device", "cpu", "-r", "8", "6", "-f", str(tmp_path / "x.png"), *flags, str(dae)]) == 0
        assert "Rendering on 1 shard(s) over 1 device(s): cpu" in capsys.readouterr().out
