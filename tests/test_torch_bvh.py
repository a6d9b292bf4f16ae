"""The port's binary BVH (build and walk) against the JAX package's, and kernel G against its plain version.

``accel/bvh.py`` is a copy of the JAX builder: the NumPy ``mean`` and
``sah`` methods and the native SAH builder give the same arrays exactly.
``bvh_walk_plain`` (kernel G's plain version) is held to the JAX XLA walk
(``intersect_rays`` / ``occluded_rays``) on terrain 40 with 12 spheres and
hard lanes (zero direction components, t_lo < 0, t_hi = 0, short t_hi, a
NaN lane).  Tolerances: ``found`` and ``prim`` equal on every lane, ``t``
rtol 1e-5, ``b1``/``b2`` atol 2e-5, ``tests`` equal on at least 99.9% of
lanes (XLA:CPU fuses the Moller-Trumbore products into FMAs, the port
rounds each; see ROADMAP Queue 3 item 3).  On the card (``-m gpu``),
kernel G equals ``bvh_walk_plain`` bit for bit.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import lens_flare_tpu.accel.native as j_native
    from lens_flare_tpu.accel.bvh import build_bvh as j_build_bvh
    from lens_flare_tpu.ops.intersect import _make_traverse, intersect_rays, occluded_rays
    from lens_flare_tpu.ops.intersect import scene_to_device as j_scene_to_device
    from lens_flare_tpu.scene.procedural import make_terrain_scene as j_terrain
except ImportError:  # the card's machine: only the gpu cases can run
    jax = None

import lens_flare_tpu_torch.accel.native as native
from lens_flare_tpu_torch.accel.bvh import build_bvh
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.ops.intersect import bvh_to_device
from lens_flare_tpu_torch.ops.intersect_cuda import BVH_INF, bvh_walk_plain, check_bvh_depth
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

N = 4096


def _scene(make, n_quads=40, n_sph=12):
    scene = make(n_quads)
    rng = np.random.default_rng(1)
    scene.sph_center = rng.uniform(-8, 8, (n_sph, 3)).astype(np.float32)
    scene.sph_center[:, 2] = rng.uniform(1, 3, n_sph)
    scene.sph_radius = rng.uniform(0.3, 1.0, n_sph).astype(np.float32)
    scene.sph_bsdf = np.zeros(n_sph, np.int32)
    return scene


def _rays(n=N, seed=2):
    """Rays from above the terrain toward it, with hard lanes mixed in."""
    rng = np.random.default_rng(seed)
    o = (np.array([[0.0, 0.0, 12.0]]) + rng.normal(0, 2, (n, 3))).astype(np.float32)
    tgt = rng.uniform(-9, 9, (n, 3))
    tgt[:, 2] = rng.uniform(0, 2, n)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::11, 0] = 0.0  # on slab planes: the NaN-safe reciprocal
    d[5] = np.nan
    t_lo = np.full(n, 1e-3, np.float32)
    t_hi = np.full(n, 1e30, np.float32)
    t_hi[::7] = rng.uniform(1, 20, len(t_hi[::7]))  # short shadow-like clips
    t_lo[::13] = -1.0
    t_hi[3::17] = 0.0  # dead lanes
    return o, d, t_lo, t_hi


needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX for the reference walk")
FIELDS = ("node_min", "node_max", "node_left", "node_right", "node_start", "node_count", "prim_order")


@needs_jax
@pytest.mark.parametrize("method", ["sah-native", "sah-numpy", "mean"])
def test_build_bvh_matches_jax(method, monkeypatch):
    scene = _scene(make_terrain_scene, 24)
    lo, hi = scene.primitive_bboxes()
    if method == "sah-numpy":  # both sides without their native builders
        monkeypatch.setattr(native, "build_bvh_native", lambda *a, **k: None)
        monkeypatch.setattr(j_native, "build_bvh_native", lambda *a, **k: None)
    m = method.split("-")[0]
    got, want = build_bvh(lo, hi, method=m), j_build_bvh(lo, hi, method=m)
    if method == "sah-native":
        assert native.build_bvh_native(lo, hi) is not None, "g++ did not build the native builder"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.max_depth == want.max_depth and got.num_nodes == want.num_nodes
    assert (got.node_count[got.node_count > 0] <= 4).all()


@needs_jax
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_bvh_walk_plain_matches_jax(any_hit):
    scene = _scene(make_terrain_scene)
    j_scene = _scene(j_terrain)
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)
    rays = _rays()
    jrays = [jnp.asarray(x) for x in rays]
    t, prim, b1, b2, found, tests = bvh_walk_plain(
        bvh_to_device(scene, bvh, "cpu"), *(torch.as_tensor(x) for x in rays), any_hit=any_hit
    )
    js = j_scene_to_device(j_scene, j_build_bvh(*j_scene.primitive_bboxes()))
    if any_hit:
        want_found, want_tests = occluded_rays(js, *jrays, return_tests=True)
    else:
        hit, want_tests = intersect_rays(js, *jrays, return_tests=True)
        want_found = hit.hit
    found, want_found = found.numpy(), np.asarray(want_found)
    np.testing.assert_array_equal(found, want_found)
    assert found.mean() > 0.5 and not found[5]  # most lanes hit; the NaN lane misses
    assert (tests.numpy() == np.asarray(want_tests)).mean() >= 0.999
    if not any_hit:
        np.testing.assert_array_equal(prim.numpy(), np.asarray(hit.prim))
        assert (prim.numpy() >= scene.num_triangles).sum() > 100  # spheres are hit
        np.testing.assert_allclose(t.numpy()[found], np.asarray(hit.t)[found], rtol=1e-5)
        assert (t.numpy()[~found] == BVH_INF).all()
        # the walk's own barycentrics (the Hit above holds only the normal built from them)
        traverse = _make_traverse(scene.num_triangles, 4, 64, any_hit=False)
        _, _, jb1, jb2, _, _ = jax.vmap(lambda *r: traverse(js, *r))(*jrays)
        tri = found & (prim.numpy() < scene.num_triangles)
        np.testing.assert_allclose(b1.numpy()[tri], np.asarray(jb1)[tri], atol=2e-5)
        np.testing.assert_allclose(b2.numpy()[tri], np.asarray(jb2)[tri], atol=2e-5)


@needs_jax
def test_bvh_walk_plain_matches_jax_in_a_box(tmp_path):
    """On a Cornell box file (axis-aligned walls: boxes that share planes, ties of entry t), identical
    rays give the JAX walk's found, prim and tests on every lane."""
    import chip_smoke
    from lens_flare_tpu.scene.build import load_scene as j_load_scene
    from lens_flare_tpu_torch.scene.build import load_scene

    path = chip_smoke.cornell_box().write(tmp_path / "cornell.dae")
    scene, _ = load_scene(path)
    j_scene, _ = j_load_scene(path)
    rng = np.random.default_rng(0)
    n = 8192
    o = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = (o, d, np.full(n, 1e-4, np.float32), np.full(n, 1e30, np.float32))
    got = bvh_walk_plain(bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), "cpu"),
                         *(torch.as_tensor(x) for x in rays))
    js = j_scene_to_device(j_scene, j_build_bvh(*j_scene.primitive_bboxes()))
    hit, tests = intersect_rays(js, *(jnp.asarray(x) for x in rays), return_tests=True)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(hit.hit))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(hit.prim))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(tests))


def test_depth_guard():
    """More levels than G's 64-entry stack raise, in the wrapper and in the plain version."""
    scene = _scene(make_terrain_scene, 4, 0)
    bv = bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), "cpu")
    deep = bv._replace(max_depth=65)
    rays = [torch.as_tensor(x) for x in _rays(8)]
    with pytest.raises(ValueError, match="64"):
        ic.bvh_walk(deep, *rays)
    with pytest.raises(ValueError, match="64"):
        bvh_walk_plain(deep, *rays)
    check_bvh_depth(64)
    out = ic.bvh_walk(bv._replace(max_depth=64), *rays)  # the CPU path: the plain version, no launch
    assert len(out) == 6 and ic.KERNELS["G"].symbol == "lf_bvh_walk"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel G has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_kernel_g_matches_plain_on_card(any_hit, cuda_device):
    """Kernel G equals bvh_walk_plain on the card, every output bit for bit, hard lanes included."""
    scene = _scene(make_terrain_scene)
    bv = bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), cuda_device)
    rays = [torch.as_tensor(x).to(cuda_device) for x in _rays()]
    before = ic.KERNELS["G"].launches
    got = ic.bvh_walk(bv, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    assert ic.KERNELS["G"].launches == before + 1
    want = bvh_walk_plain(bv, *rays, any_hit=any_hit)
    for name, g, w in zip(("t", "prim", "b1", "b2", "found", "tests"), got, want):
        assert torch.equal(g, w), name
