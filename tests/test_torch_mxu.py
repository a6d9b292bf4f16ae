"""Kernel E, the coefficient walk: tables and plain version against the Pallas kernel.

The port packs the Möller-Trumbore coefficients slot-major,
(B1*B2*K, 4, 16), where ``PallasScene(mxu=True)`` packs them as
(16, B_nodes*128) lanes; after that layout change both tables, and the top
centres, are equal bit for bit (both are built in float64 from the same
``WideBVH``, then cast).

``intersect(..., mxu=True)`` (the plain version of ``lf_tree_closest_mxu``)
is held against ``intersect_pallas(interpret=True, mxu=True)`` on 1024
random rays, as ``tests/test_pallas.py`` holds the classic walk against the
coefficient walk: hits and prims equal, t within rtol 1e-3 / atol 1e-5 (the
affine forms cancel: the port sums ten float32 products in order, XLA:CPU's
matrix product sums them in its own order), and the per-lane test counts
equal (the walk is kernel A's at chunk batch 1; no product decides a box).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.accel.wide import build_wide_bvh
from lens_flare_tpu.ops.intersect_pallas import PallasScene, intersect_pallas
from lens_flare_tpu.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.convert import cuda_scene_from_wide_bvh
from lens_flare_tpu_torch.ops import intersect_cuda as ic

NONE = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
# (n_quads, tree shape): the exact-fit multi-level tree of tools/ab_mxu_mt.py,
# and a single-level tree (centre of the valid child boxes)
SCENES = {"terrain64_8x32x32": (64, (8, 32, 32)), "terrain20_single_level": (20, ())}


def _setup(name):
    nq, shape = SCENES[name]
    scene = make_terrain_scene(nq)
    wb = build_wide_bvh(scene.tri_p, *shape)
    ps = PallasScene(wb, *NONE, scene.num_triangles, mxu=True)
    cs = cuda_scene_from_wide_bvh(wb, *NONE, scene.num_triangles, mxu=True)
    assert ps.mxu and cs.mxu and cs.k == 32
    return scene, ps, cs


def _rays(scene, n=1024):
    """test_pallas.py's coefficient-walk rays: random origins around the terrain."""
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(scene.bbox_min), np.asarray(scene.bbox_max)
    o = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, 1e30, np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_tables_equal_pallas_scene(name):
    _, ps, cs = _setup(name)
    n_slots = cs.b1 * cs.b2 * cs.k
    planes = np.asarray(ps.mxu_planes)  # (16, B_nodes*128): lane = node*128 + out*K + slot
    want = planes.reshape(16, cs.b1 * cs.b2, 4, cs.k).transpose(1, 3, 2, 0).reshape(n_slots, 4, 16)
    np.testing.assert_array_equal(cs.mxu_coef.numpy(), want)
    np.testing.assert_array_equal(cs.mxu_centers.numpy(), np.asarray(ps.mxu_centers)[0:3, : cs.b1].T)


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_pallas_mxu(name):
    scene, ps, cs = _setup(name)
    rays = _rays(scene)
    jo = intersect_pallas(ps, *(jnp.asarray(x) for x in rays), interpret=True, mxu=True)
    to = ic.intersect(cs, *(torch.from_numpy(x) for x in rays), mxu=True)
    jt, jp, _, _, jh, jtests = (np.asarray(x) for x in jo)
    tt, tp, _, _, th, ttests = (x.numpy() for x in to)
    assert jh.sum() > 200
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tp[jh], jp[jh])
    np.testing.assert_allclose(tt[jh], jt[jh], rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(ttests, jtests)
    # and against the port's classic walk: the same hits, t to the same tolerance
    base = ic.intersect(cs, *(torch.from_numpy(x) for x in rays))
    np.testing.assert_array_equal(th, base[4].numpy())
    np.testing.assert_array_equal(tp[th], base[1].numpy()[th])
    np.testing.assert_allclose(tt[th], base[0].numpy()[th], rtol=1e-3, atol=1e-5)


def test_mxu_raises_where_pallas_does():
    scene, ps, cs = _setup("terrain64_8x32x32")
    rays = _rays(scene, 64)
    plain = ic.intersect(cs, *(torch.from_numpy(x) for x in rays))  # classic walk still works
    assert plain[4].any()
    for kw in ({"any_hit": True}, {"brute": True, "any_hit": True}):
        with pytest.raises(ValueError):
            intersect_pallas(ps, *(jnp.asarray(x) for x in rays), interpret=True, mxu=True, **kw)
        with pytest.raises(ValueError):
            ic.intersect(cs, *(torch.from_numpy(x) for x in rays), mxu=True, **kw)
    # a scene packed without the table
    wb = build_wide_bvh(scene.tri_p, 8, 32, 32)
    ps0 = PallasScene(wb, *NONE, scene.num_triangles)
    cs0 = cuda_scene_from_wide_bvh(wb, *NONE, scene.num_triangles)
    assert not ps0.mxu and not cs0.mxu
    with pytest.raises(ValueError):
        intersect_pallas(ps0, *(jnp.asarray(x) for x in rays), interpret=True, mxu=True)
    with pytest.raises(ValueError):
        ic.intersect(cs0, *(torch.from_numpy(x) for x in rays), mxu=True)
    with pytest.raises(ValueError):
        ic.tree_closest_mxu(cs0, *(torch.from_numpy(x) for x in rays))
    # a shade scene's shade trace, and a stream or brute scene, take no table
    rows = np.zeros((scene.num_triangles, 10), np.float32)
    cs_sh = cuda_scene_from_wide_bvh(wb, *NONE, scene.num_triangles, shade_rows=rows, mxu=True)
    assert cs_sh.shade and cs_sh.mxu
    with pytest.raises(ValueError):
        ic.intersect(cs_sh, *(torch.from_numpy(x) for x in rays), mxu=True, return_shade=True)
    assert not cuda_scene_from_wide_bvh(wb, *NONE, scene.num_triangles, force_stream=True, mxu=True).mxu
    small = make_terrain_scene(8)
    assert not cuda_scene_from_wide_bvh(build_wide_bvh(small.tri_p), *NONE, small.num_triangles, mxu=True).mxu
    # K = 32 only, as PallasScene asserts
    with pytest.raises(ValueError):
        cuda_scene_from_wide_bvh(build_wide_bvh(scene.tri_p, 16, 32, 16), *NONE, scene.num_triangles, mxu=True)
