"""Kernel F, the top-batched group walk: plain version against the Pallas kernel.

``intersect(..., top_batch=tb)`` (the plain version of ``lf_tree_group`` on
the CPU) is held against ``intersect_pallas(interpret=True, top_batch=tb)``
for tb in (2, 4), closest hit, any hit and ``return_shade``, on the
3,200-triangle terrain (a (16, 32, 32) tree) with the rays of the JAX
package's own group-walk tests (``tests/test_pallas.py``): every output,
``tests`` included.  Tolerances are those of ``test_torch_intersect.py``
(``_compare``): XLA:CPU contracts the Möller-Trumbore products into fused
multiply-adds, the port rounds every product, so t and the barycentrics
move by a few ulps and a grazing ray may flip; per-lane test counts equal
on >= 99.9% of lanes.  The port's own TB=1 walk (kernels A, B, D) must give
the same t, slot, barycentrics, hits and rows exactly.  Ragged cases
(N not a multiple of the tile) cover the tile's padding lanes, and an
any-hit case with t_lo = 0 covers occluded lanes that stay charged until
their tile stops.
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
from test_torch_intersect import _compare


def _shade_rows(scene):
    n_t = scene.num_triangles
    return np.concatenate(
        [np.asarray(scene.tri_n, np.float32).reshape(n_t, 9),
         np.asarray(scene.tri_bsdf, np.float32).reshape(n_t, 1)], axis=1,
    )


@pytest.fixture(scope="module")
def scenes():
    scene = make_terrain_scene(40)
    wb = build_wide_bvh(scene.tri_p)
    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    rows = _shade_rows(scene)
    ps = PallasScene(wb, *none, scene.num_triangles, shade_rows=rows)
    cs = cuda_scene_from_wide_bvh(wb, *none, scene.num_triangles, shade_rows=rows)
    assert ps.b1 > 1 and not ps.stream and ps.shade and cs.shade and not cs.stream
    return ps, cs


def _rays(kind, n):
    """The rays of test_pallas.py's group-walk tests (seed 1 closest, seed 3 any hit)."""
    any_hit = kind.startswith("any_hit")
    rng = np.random.default_rng(3 if any_hit else 1)
    o = np.stack(
        [rng.uniform(-9, 9, n), rng.uniform(-9, 9, n), rng.uniform(2.0, 4.0, n)], axis=-1
    ).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_lo = np.full(n, 1e-4, np.float32)
    if any_hit:
        # dead, finite and infinite intervals
        i = np.arange(n) % 3
        t_hi = np.where(i == 0, 0.0, np.where(i == 1, 5.0, 1e30)).astype(np.float32)
        if kind == "any_hit_t_lo_0":
            # origins on the terrain's surface layer, t_lo = 0: an occluded
            # lane still hits the boxes around its origin under [0, 0]
            t_lo[np.arange(n) % 2 == 0] = 0.0
            o[:, 2] = rng.uniform(-0.5, 1.5, n)
    else:
        t_hi = np.full(n, 1e30, np.float32)
    return o, d, t_lo, t_hi


KINDS = {
    # kind: (n, any_hit, return_shade)
    "closest": (512, False, False),
    "closest_ragged": (700, False, False),
    "shade": (512, False, True),
    "any_hit": (512, True, False),
    "any_hit_ragged": (700, True, False),
    "any_hit_t_lo_0": (1536, True, False),
}


def _both(ps, cs, rays, tb, any_hit, shade):
    o, d, t_lo, t_hi = rays
    jo = intersect_pallas(
        ps, *(jnp.asarray(x) for x in rays), interpret=True, any_hit=any_hit,
        return_shade=shade, top_batch=tb,
    )
    to = ic.intersect(
        cs, *(torch.from_numpy(x) for x in rays), any_hit=any_hit, return_shade=shade, top_batch=tb,
    )
    return jo, to


@pytest.mark.parametrize("tb", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_group_walk_matches_pallas(scenes, kind, tb):
    ps, cs = scenes
    n, any_hit, shade = KINDS[kind]
    rays = _rays(kind, n)
    jo, to = _both(ps, cs, rays, tb, any_hit, shade)
    _compare(jo[:6], to[:6], any_hit)
    if shade:
        # the rows are the winning slot's: equal wherever both found the same triangle
        same = np.asarray(jo[4]) & to[4].numpy() & (np.asarray(jo[1]) == to[1].numpy())
        assert same.sum() > 100
        np.testing.assert_array_equal(np.asarray(jo[6]).T[same], to[6].numpy()[same])
    # the port's own TB = 1 walk (kernel A, B or D) finds the same hits
    base = ic.intersect(cs, *(torch.from_numpy(x) for x in rays), any_hit=any_hit, return_shade=shade)
    for j, (g, w) in enumerate(zip(to, base)):
        if j != 5:  # tests: the group walk clips at the group's start
            assert torch.equal(g, w), j
    assert to[4].sum() > 50


def test_group_walk_charges_more_than_default(scenes):
    """The clip fixed per group tests at least the chunks of the per-top clip."""
    _, cs = scenes
    rays = [torch.from_numpy(x) for x in _rays("closest", 512)]
    base = ic.intersect(cs, *rays)[5]
    for tb in (2, 4):
        got = ic.intersect(cs, *rays, top_batch=tb)[5]
        assert (got >= base).all() and got.sum() > base.sum()


def test_t_lo_0_lanes_stay_charged(scenes):
    """An occluded lane with t_lo <= 0 is charged until its tile stops (intersect_pallas.py:803-816)."""
    _, cs = scenes
    o, d, t_lo, t_hi = (torch.from_numpy(x) for x in _rays("any_hit_t_lo_0", 1536))
    # the same lanes with t_lo > 0 stop being charged once occluded
    pos = ic.intersect(cs, o, d, torch.full_like(t_lo, 1e-4), t_hi, any_hit=True, top_batch=2)[5]
    zero = ic.intersect(cs, o, d, t_lo, t_hi, any_hit=True, top_batch=2)[5]
    assert (zero[t_lo == 0] > pos[t_lo == 0]).any()


def test_top_batch_clamps_where_pallas_does():
    """TB clamps to 1 (kernels A, B) on single-level and stream scenes; mxu forces it too."""
    for nq, kw in ((8, {}), (40, {"force_stream": True})):
        scene = make_terrain_scene(nq)
        wb = build_wide_bvh(scene.tri_p)
        none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
        cs = cuda_scene_from_wide_bvh(wb, *none, scene.num_triangles, **kw)
        rays = [torch.from_numpy(x) for x in _rays("closest", 256)]
        for any_hit in (False, True):
            got = ic.intersect(cs, *rays, any_hit=any_hit, top_batch=4)
            want = ic.intersect(cs, *rays, any_hit=any_hit)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        with pytest.raises(ValueError):
            ic.tree_group(cs, *rays, 2)
