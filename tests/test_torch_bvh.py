"""The port's binary BVH (build, packing and walk) against the JAX package's, and kernel G against its plain version.

``accel/bvh.py`` is a copy of the JAX builder: the NumPy ``mean`` and
``sah`` methods and the native SAH builder give the same arrays exactly.
``bvh_to_device`` packs the tree as child-pair records and leaf-ordered
rows; ``unpack_bvh`` gives back the ``FlatBVH`` and the scene's rows bit
for bit.  ``bvh_walk_plain`` (kernel G's plain version, over the packed
layout) is held to the JAX XLA walk (``intersect_rays`` /
``occluded_rays``) on terrain 40 with 12 spheres and hard lanes (zero
direction components, t_lo < 0, t_hi = 0, short t_hi, a NaN lane), and on
the edge scenes: a root that is a leaf, spheres only, triangles only.
Tolerances: ``found`` and ``prim`` equal on every lane, ``t`` rtol 1e-5,
``b1``/``b2`` atol 2e-5, ``tests`` equal on at least 99.9% of lanes
(XLA:CPU fuses the Moller-Trumbore products into FMAs, the port rounds
each; see ROADMAP Queue 3 item 4).  The empty scene, which the JAX walk
cannot index, misses on every lane.  The walk over the ``FlatBVH``'s own
arrays, as kernel G read them before the packing (``_flat_walk``), gives
the same outputs bit for bit and the same visits, so ``bvh_bound`` counts
the same work.  On the card (``-m gpu``), kernel G equals
``bvh_walk_plain`` bit for bit, on every edge scene and ragged ray count.
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
from lens_flare_tpu_torch import bench_kernels as bk
from lens_flare_tpu_torch.ops.intersect import bvh_to_device, unpack_bvh
from lens_flare_tpu_torch.ops.intersect_cuda import (
    BVH_INF, BVH_MAX_LEAF, BVH_MAX_STACK, _bvh_box, _bvh_sphere, _mt_terms, _safe_inv, bvh_walk_plain,
    check_bvh_depth,
)
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


def _edge_scene(name, make=make_terrain_scene):
    """The packing's edge scenes: terrain 40 with 12 spheres, a root that is a leaf (2 triangles and a
    sphere), spheres only, triangles only, and the empty scene (``build_bvh`` gives one childless root)."""
    n_quads, n_sph, tris = {"terrain40_spheres12": (40, 12, True), "root_leaf": (1, 1, True),
                            "spheres_only": (2, 30, False), "triangles_only": (40, 0, True),
                            "empty": (2, 0, False)}[name]
    scene = _scene(make, n_quads, n_sph)
    if not tris:
        scene.tri_p, scene.tri_n, scene.tri_bsdf = scene.tri_p[:0], scene.tri_n[:0], scene.tri_bsdf[:0]
    return scene


EDGE_SCENES = ("terrain40_spheres12", "root_leaf", "spheres_only", "triangles_only", "empty")
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


@pytest.mark.parametrize("name", EDGE_SCENES)
def test_packing_round_trip(name):
    """Unpacking the records and rows gives the FlatBVH and the scene's triangle and sphere rows bit for bit."""
    scene = _edge_scene(name)
    bvh = build_bvh(*scene.primitive_bboxes())
    bv = bvh_to_device(scene, bvh, "cpu")
    got, tri, sph = unpack_bvh(bv)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(bvh, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(bvh, f).dtype, f
    assert got.max_depth == bvh.max_depth and got.num_nodes == bvh.num_nodes == bv.num_nodes
    tri_p = np.asarray(scene.tri_p, np.float32)
    want_tri = np.zeros((len(tri_p), 12), np.float32)
    want_tri[:, 0:3], want_tri[:, 3:6], want_tri[:, 6:9] = tri_p[:, 0], tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0]
    want_sph = np.zeros((scene.num_spheres, 8), np.float32)
    want_sph[:, 0:3], want_sph[:, 3] = scene.sph_center, scene.sph_radius
    assert tri.tobytes() == want_tri.tobytes() and sph.tobytes() == want_sph.tobytes()
    # one record per node the walk treats as interior, half the nodes (and one for a tree without any)
    inner = int((bvh.node_count == 0).sum())
    assert bv.nodes.shape == (max(inner, 1), 16) and bv.rows.shape == (max(len(bvh.prim_order), 1), 12)
    assert inner == (bvh.num_nodes - 1) // 2 or name == "empty"


def _flat_walk(scene, bvh, o, d, t_lo, t_hi, any_hit):
    """The lockstep walk over the FlatBVH's own arrays, node by node as the XLA walk pops them: kernel G's
    plain version before the packing.  Returns (t, prim, b1, b2, found, tests) and its visits."""
    tri_p = torch.as_tensor(np.asarray(scene.tri_p, np.float32))
    tri = torch.cat([tri_p[:, 0], tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0]], 1)
    sph = torch.cat([torch.as_tensor(np.asarray(scene.sph_center, np.float32)).reshape(-1, 3),
                     torch.as_tensor(np.asarray(scene.sph_radius, np.float32))[:, None]], 1)
    box = torch.as_tensor(np.concatenate([bvh.node_min, bvh.node_max], 1))
    link = torch.as_tensor(np.stack([bvh.node_left, bvh.node_right, bvh.node_start, bvh.node_count], 1)).long()
    order = torch.as_tensor(bvh.prim_order).long()
    n_tri, n_sph, n_prim = len(tri), len(sph), max(len(order), 1)
    n = o.shape[0]
    inv = _safe_inv(d)
    best_t = torch.full((n,), BVH_INF)
    best_p = torch.full((n,), -1, dtype=torch.int32)
    out_b1, out_b2 = torch.zeros(n), torch.zeros(n)
    found = torch.zeros(n, dtype=torch.bool)
    tests = torch.zeros(n, dtype=torch.int32)
    stack = torch.zeros((n, BVH_MAX_STACK), dtype=torch.int64)
    sp = _bvh_box(box[:1].expand(n, 6), o, inv, t_lo, t_hi)[0].long()
    visits = {"nodes": torch.zeros(len(box), dtype=torch.bool), "prims": torch.zeros(n_prim, dtype=torch.bool),
              "interior": torch.zeros(n, dtype=torch.int32)}
    while True:
        lanes = (((sp > 0) & ~found) if any_hit else sp > 0).nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        sp_l = sp[lanes] - 1
        node = stack[lanes, sp_l]
        left, right, start, count = link[node].unbind(1)
        ol, dl, il, lo, hi = o[lanes], d[lanes], inv[lanes], t_lo[lanes], t_hi[lanes]
        bt, bp, b1, b2, fd, ts = best_t[lanes], best_p[lanes], out_b1[lanes], out_b2[lanes], found[lanes], tests[lanes]
        is_leaf = count > 0
        for s in range(BVH_MAX_LEAF):
            ok = is_leaf & (s < count)
            slot = torch.clamp(start + s, max=n_prim - 1)
            p = order[slot] if len(order) else torch.zeros_like(slot)
            is_tri = p < n_tri
            limit = torch.minimum(hi, bt)
            valid, t, tb1, tb2 = torch.zeros_like(ok), torch.full_like(bt, BVH_INF), torch.zeros_like(bt), torch.zeros_like(bt)
            if n_tri:
                det, tt_n, bb1_n, bb2_n = _mt_terms(tri[torch.clamp(p, max=n_tri - 1)], ol, dl)
                inv_det = torch.where(det != 0, 1.0 / det, 0.0)
                t, tb1, tb2 = tt_n * inv_det, bb1_n * inv_det, bb2_n * inv_det
                valid = (det != 0) & (t >= lo) & (t <= limit) & (tb1 >= 0) & (tb1 <= 1) & (tb2 >= 0) & (tb2 <= 1) & (tb1 + tb2 <= 1)
            if n_sph:
                sv, st = _bvh_sphere(sph[torch.clamp(p - n_tri, 0, n_sph - 1)], ol, dl, lo, limit)
                valid, t = torch.where(is_tri, valid, sv), torch.where(is_tri, t, st)
            valid = valid & ok
            better = valid & (t < bt)
            bt, bp = torch.where(better, t, bt), torch.where(better, p.to(torch.int32), bp)
            b1, b2 = torch.where(better & is_tri, tb1, b1), torch.where(better & is_tri, tb2, b2)
            fd, ts = fd | valid, ts + ok.to(torch.int32)
            visits["prims"][slot[ok]] = True
        limit = torch.minimum(hi, bt)
        interior = ~is_leaf
        l_ok, l_t = _bvh_box(box[left.clamp_min(0)], ol, il, lo, limit)
        r_ok, r_t = _bvh_box(box[right.clamp_min(0)], ol, il, lo, limit)
        l_ok, r_ok = l_ok & interior & (left >= 0), r_ok & interior & (right >= 0)
        near_left = l_t <= r_t
        far, far_ok = torch.where(near_left, right, left), torch.where(near_left, r_ok, l_ok)
        near, near_ok = torch.where(near_left, left, right), torch.where(near_left, l_ok, r_ok)
        stack[lanes, sp_l] = torch.where(far_ok, far, stack[lanes, sp_l])
        sp_l = sp_l + far_ok.long()
        top = torch.clamp(sp_l, max=BVH_MAX_STACK - 1)
        stack[lanes, top] = torch.where(near_ok, near, stack[lanes, top])
        sp[lanes] = sp_l + near_ok.long()
        best_t[lanes], best_p[lanes], out_b1[lanes], out_b2[lanes], found[lanes], tests[lanes] = bt, bp, b1, b2, fd, ts
        visits["nodes"][node] = True
        visits["interior"][lanes] += interior.to(torch.int32)
    return (best_t, best_p, out_b1, out_b2, found, tests), visits


def _flat_bound(scene, bvh, rays, out, visits):
    """bench_kernels.bvh_bound's formula as it read the FlatBVH's own prim_order."""
    ids = torch.as_tensor(bvh.prim_order).long()[visits["prims"][: len(bvh.prim_order)]]
    n_tri = int((ids < scene.num_triangles).sum())
    nbytes = (rays[0].shape[0] * bk.G_LANE_BYTES + int(visits["nodes"].sum()) * bk.G_NODE_BYTES
              + n_tri * (bk.TRI_ROW_BYTES + 4) + (ids.numel() - n_tri) * (bk.G_SPHERE_BYTES + 4))
    box_tests = rays[0].shape[0] + 2 * float(visits["interior"].sum(dtype=torch.float64))
    flops = float(out[5].sum(dtype=torch.float64)) * bk.FLOP_PER_TEST["closest"] + box_tests * bk.BOX_TEST_FLOP
    t_ops, t_bytes = flops / bk.PEAK_FLOPS, nbytes / bk.PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("name", ["terrain40_spheres12", "root_leaf", "empty"])
def test_packed_walk_and_bound_match_the_flat_walk(name, any_hit):
    """Over the packed layout the plain walk gives the FlatBVH walk's outputs bit for bit and pops the same
    nodes and rows, so bvh_bound gives the bound of the walk before the packing for the same rays."""
    scene = _edge_scene(name)
    bvh = build_bvh(*scene.primitive_bboxes())
    bv = bvh_to_device(scene, bvh, "cpu")
    rays = [torch.as_tensor(x) for x in _rays(2045)]
    visits = {}
    got = bvh_walk_plain(bv, *rays, any_hit=any_hit, visits=visits)
    want, want_visits = _flat_walk(scene, bvh, *rays, any_hit)
    for label, g, w in zip(("t", "prim", "b1", "b2", "found", "tests"), got, want):
        assert torch.equal(g, w), label
    for key in ("nodes", "prims", "interior"):
        assert torch.equal(visits[key], want_visits[key]), key
    assert name != "terrain40_spheres12" or int(visits["nodes"].sum()) > 100
    assert bk.bvh_bound(bv, rays, got, visits) == _flat_bound(scene, bvh, rays, want, want_visits)


@needs_jax
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("name", ["root_leaf", "spheres_only", "triangles_only"])
def test_bvh_walk_plain_edge_scenes_match_jax(name, any_hit):
    """The packed walk against the JAX XLA walk on the edge scenes, with the tolerances of the terrain test."""
    scene, j_scene = _edge_scene(name), _edge_scene(name, j_terrain)
    rays = _rays(2045)
    t, prim, b1, b2, found, tests = bvh_walk_plain(
        bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), "cpu"), *(torch.as_tensor(x) for x in rays),
        any_hit=any_hit,
    )
    js = j_scene_to_device(j_scene, j_build_bvh(*j_scene.primitive_bboxes()))
    jrays = [jnp.asarray(x) for x in rays]
    traverse = _make_traverse(j_scene.num_triangles, 4, 64, any_hit=any_hit)
    jt, jp, jb1, jb2, jf, jtests = (np.asarray(x) for x in jax.vmap(lambda *r: traverse(js, *r))(*jrays))
    found = found.numpy()
    np.testing.assert_array_equal(found, jf)
    assert found.sum() > 50 and not found[5]
    assert (tests.numpy() == jtests).mean() >= 0.999
    if not any_hit:
        np.testing.assert_array_equal(prim.numpy(), jp)
        np.testing.assert_allclose(t.numpy()[found], jt[found], rtol=1e-5)
        assert (t.numpy()[~found] == BVH_INF).all()
        tri = found & (prim.numpy() < scene.num_triangles)
        np.testing.assert_allclose(b1.numpy()[tri], jb1[tri], atol=2e-5)
        np.testing.assert_allclose(b2.numpy()[tri], jb2[tri], atol=2e-5)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_bvh_walk_plain_empty_scene_misses(any_hit):
    """The empty scene (one childless root; the JAX walk cannot index its empty prim_order) misses on
    every lane with no test, t = 1e30 and prim = -1."""
    scene = _edge_scene("empty")
    bv = bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), "cpu")
    t, prim, b1, b2, found, tests = bvh_walk_plain(bv, *(torch.as_tensor(x) for x in _rays(2045)), any_hit=any_hit)
    assert (t == BVH_INF).all() and (prim == -1).all() and (b1 == 0).all() and (b2 == 0).all()
    assert not found.any() and (tests == 0).all()


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


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("name", EDGE_SCENES)
def test_kernel_g_edge_scenes_on_card(name, any_hit, cuda_device):
    """Kernel G equals bvh_walk_plain bit for bit on every edge scene, at 2045 rays (not a multiple of 32 or
    128), at 1 ray and at none."""
    scene = _edge_scene(name)
    bv = bvh_to_device(scene, build_bvh(*scene.primitive_bboxes()), cuda_device)
    for n in (2045, 1, 0):
        rays = [torch.as_tensor(x[:n]).to(cuda_device) for x in _rays(2045)]
        before = ic.KERNELS["G"].launches
        got = ic.bvh_walk(bv, *rays, any_hit=any_hit)
        torch.cuda.synchronize()
        assert ic.KERNELS["G"].launches == before + 1
        want = bvh_walk_plain(bv, *rays, any_hit=any_hit)
        for label, g, w in zip(("t", "prim", "b1", "b2", "found", "tests"), got, want):
            assert torch.equal(g, w), (n, label)
