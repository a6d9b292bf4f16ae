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

``test_exit_decomposition_matches_plain`` recomputes the any-hit walk's
``tests`` the way kernel F's passes split it (per-lane done groups, each
tile's exit group, the lanes charged past their own end) and holds it to the
plain version lane for lane.
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
from test_torch_intersect import _compare, _exit_rays


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


def _free_walk(cs, o, d, t_lo, t_hi, tb, tile):
    """Any-hit group walk of every lane over its tile's whole list, no tile exit.

    Returns (tests charged per group (G, N), occluded at each group's start
    (G, N), groups per tile, each lane's tile).
    """
    n = o.shape[0]
    b1, b2, k = cs.b1, cs.b2, cs.k
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    padded = torch.nn.functional.pad
    flags = ic._box_hits(
        cs.top, padded(o, (0, 0, 0, pad)), ic._safe_inv(padded(d, (0, 0, 0, pad))),
        padded(t_lo, (0, pad)), padded(t_hi, (0, pad)),
    ).view(n_tiles, tile, b1).any(dim=1)
    tops = torch.where(flags, torch.arange(b1), b1).sort(dim=1).values
    n_groups = (flags.sum(dim=1) + tb - 1) // tb
    g_max = int(n_groups.max())
    lane_tile = torch.arange(n) // tile
    inv = ic._safe_inv(d)
    child = cs.child.view(b1, b2, 8)
    tri = cs.tri.view(b1 * b2, k, 12)
    occluded = torch.zeros(n, dtype=torch.bool)
    charged = torch.zeros(g_max, n, dtype=torch.int32)
    occ_start = torch.zeros(g_max, n, dtype=torch.bool)
    for g in range(g_max):
        occ_start[g] = occluded
        t_clip = torch.where(occluded, 0.0, t_hi)
        hit = torch.zeros(n, dtype=torch.bool)
        for u in range(min(tb, b1 - g * tb)):
            tl = tops[:, g * tb + u][lane_tile]
            lanes = (tl < b1).nonzero()[:, 0]
            tp = tl[lanes]
            keep = ic._box_hits(cs.top[tp][:, None, :], o[lanes], inv[lanes], t_lo[lanes], t_clip[lanes])[:, 0]
            lanes, tp = lanes[keep], tp[keep]
            ch = ic._box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_clip[lanes])
            charged[g].index_add_(0, lanes, (k * ch.sum(dim=1)).to(torch.int32))
            pl, pc = (ch & ~occluded[lanes, None]).nonzero(as_tuple=True)
            gl = lanes[pl]
            terms = ic._mt_terms(tri[tp[pl] * b2 + pc], o[gl, None, :], d[gl, None, :])
            hit[gl[ic._occludes(*terms, t_lo[gl, None], t_hi[gl, None]).any(dim=1)]] = True
        occluded |= hit
    return charged, occ_start, n_groups, lane_tile


@pytest.mark.parametrize("tb", [2, 4])
@pytest.mark.parametrize("shape", [(), (64, 8, 8)], ids=["16x32x32", "64x8x8"])
def test_exit_decomposition_matches_plain(shape, tb):
    """F's any-hit tests = each lane's walk to its done group + the tile's walk on to its exit group.

    A lane's done group is 0 if it is dead (t_hi <= t_lo), else one past the
    group in which it became occluded, else its tile's group count; the tile
    stops at the largest done group of its lanes.  Past its own done group a
    lane is charged only if it is occluded with t_lo <= 0 or dead with t_lo
    == t_hi.  The rays make tiles stop early with both kinds present.
    """
    scene = make_terrain_scene(40)
    wb = build_wide_bvh(scene.tri_p, *shape)
    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    cs = cuda_scene_from_wide_bvh(wb, *none, scene.num_triangles)
    rays = o, d, t_lo, t_hi = [torch.from_numpy(x) for x in _exit_rays(scene, wb, 3000)]
    charged, occ_start, n_groups, lane_tile = _free_walk(cs, *rays, tb, ic.group_tile(True))
    g = torch.arange(charged.shape[0])[:, None]
    first_occ = torch.where(occ_start, g, charged.shape[0]).min(dim=0).values
    done = torch.where(t_hi <= t_lo, 0, torch.minimum(first_occ, n_groups[lane_tile]))
    exit_group = torch.zeros(len(n_groups), dtype=torch.long).scatter_reduce(0, lane_tile, done, "amax")
    own = (charged * (g < done)).sum(dim=0)
    after = (charged * ((g >= done) & (g < exit_group[lane_tile]))).sum(dim=0)

    want = ic.tree_plain(cs, *rays, True, top_batch=tb)[3]
    assert torch.equal(own + after, want)
    occluded_low = (t_lo < t_hi) & (t_lo <= 0)
    point = t_lo == t_hi
    assert (after[~occluded_low & ~point] == 0).all()
    assert (exit_group < n_groups).any(), "no tile stopped early"
    assert (after[point] > 0).any()
    if tb == 2:
        assert (after[occluded_low] > 0).any()
