"""Kernels A-F: plain PyTorch versions against the Pallas kernels, and on the card.

Kernels E and F are held to the Pallas kernels in ``test_torch_mxu.py`` and
``test_torch_group_walk.py``; here they have their GPU-marked cases.

The JAX side runs ``intersect_pallas(..., interpret=True)``, as the JAX
package's own tests do on the CPU; the port runs the plain version of each
CUDA kernel (what its wrappers take for CPU tensors) on the same arrays and
the same ``WideBVH``.

Tolerances and why:
- hit masks, prims (where both hit) and per-lane test counts equal on
  >= 99.9% of lanes, the test-count sum within 0.1%; every mismatch must be
  a grazing ray (a barycentric within 1e-4 of a triangle edge) or a t tie;
- t within 1e-5 relative and barycentrics within 1e-5 on >= 99% of lanes
  where both hit, and within 1e-4 everywhere.  XLA:CPU contracts the
  Moller-Trumbore dot products into fused multiply-adds (the FMA-contracted
  float32 evaluation reproduces its values bit for bit), while the port and
  its kernels round every product, as the TPU did.  That moves t and the
  barycentrics by a few ulps of the largest product term, which the
  cancellation of grazing hits amplifies.

The CUDA case compares each kernel with its plain version on the card,
where both round alike (the kernels are built with --fmad=false): there the
outputs must be equal.  E's hits are also held to A's (t within rtol 1e-3:
its affine forms cancel), and F's t, slots, barycentrics, hits and rows to
A's, B's and D's exactly.  The card's machine has no JAX, so that case runs
there without this repository's conftest:
``python -m pytest --noconftest -m gpu tests/test_torch_intersect.py``.
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from lens_flare_tpu.ops.intersect_pallas import PallasScene, intersect_pallas
except ImportError:  # the card's machine: only the gpu cases can run
    jnp = None

from lens_flare_tpu.accel.wide import build_wide_bvh
from lens_flare_tpu.scene.camera import Camera
from lens_flare_tpu.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.convert import camera_params_from_numpy, cuda_scene_from_wide_bvh
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.scene.camera import generate_rays


def _spheres(n, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(1, 3, n)
    return c, rng.uniform(0.5, 2.0, n).astype(np.float32)


def _rays(scene, n_cam=1024, n_rand=1024, seed=0):
    """Camera rays over the frame plus random rays, ~20% dead lanes (t_hi = 0)."""
    rng = np.random.default_rng(seed)
    cam = Camera()
    center = (scene.bbox_min + scene.bbox_max) / 2
    extent = np.linalg.norm(scene.bbox_max - scene.bbox_min)
    cam.place(center, math.pi / 3, math.pi / 4, extent, extent / 10, extent * 10)
    cam.screen_w, cam.screen_h = 64, 48
    p = camera_params_from_numpy(cam.params())
    o1, d1 = generate_rays(p, torch.as_tensor(rng.uniform(0, 1, n_cam), dtype=torch.float32),
                           torch.as_tensor(rng.uniform(0, 1, n_cam), dtype=torch.float32))
    o2 = rng.uniform(-12, 12, (n_rand, 3)).astype(np.float32)
    o2[:, 2] = rng.uniform(-1, 8, n_rand)
    d2 = rng.normal(size=(n_rand, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([o1.numpy(), o2]).astype(np.float32)
    d = np.concatenate([d1.numpy(), d2]).astype(np.float32)
    n = len(o)
    t_lo = np.full(n, 1e-3, np.float32)
    t_hi = np.full(n, 1e30, np.float32)
    t_hi[rng.uniform(size=n) < 0.2] = 0.0
    return o, d, t_lo, t_hi


def _hard_rays(scene, n=2045, seed=5):
    """Rays for the corners of the walk, N not a multiple of the kernels' rays per block.

    A fifth each: rays aimed at a vertex or an edge midpoint of a triangle
    (ties between neighbours); shadow-like rays from just above the surface
    with t_lo <= 0, so that occluded lanes keep walking under [t_lo, 0]; a
    NaN in one of o, d, t_lo or t_hi; empty or degenerate intervals (t_lo >
    t_hi, t_lo == t_hi, t_hi < 0, t_hi = inf); and the rest from ``_rays``.
    """
    rng = np.random.default_rng(seed)
    tri = np.asarray(scene.tri_p, np.float32)
    m = n // 5
    o_r, d_r, lo_r, hi_r = _rays(scene, n, n, seed=seed)
    pick = rng.choice(len(o_r), n, replace=False)
    o, d, t_lo, t_hi = (a[pick].copy() for a in (o_r, d_r, lo_r, hi_r))

    def unit(v):
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    idx = rng.integers(0, len(tri), m)
    which = rng.integers(0, 3, m)
    corner, nxt = tri[idx, which], tri[idx, (which + 1) % 3]
    target = np.where(rng.uniform(size=(m, 1)) < 0.5, corner, (corner + nxt) * np.float32(0.5))
    src = target + rng.uniform(-3, 3, (m, 3)).astype(np.float32) + np.float32([0, 0, 6])
    o[:m], d[:m], t_lo[:m], t_hi[:m] = src, unit(target - src), 1e-3, 1e30

    bary = rng.dirichlet(np.ones(3), m).astype(np.float32)
    surf = np.einsum("mc,mcj->mj", bary, tri[rng.integers(0, len(tri), m)]) + np.float32([0, 0, 0.05])
    d_sh = rng.normal(size=(m, 3)).astype(np.float32)
    sl = slice(m, 2 * m)
    o[sl], d[sl] = surf, unit(d_sh)
    t_lo[sl] = rng.choice(np.float32([0.0, -1e-3, -2.0]), m)
    t_hi[sl] = rng.choice(np.float32([20.0, 1e30]), m)

    sl = slice(2 * m, 3 * m)
    for j, arr in enumerate((o, d, t_lo, t_hi)):
        lanes = np.arange(2 * m + j, 3 * m, 4)
        if arr.ndim == 2:
            arr[lanes, rng.integers(0, 3, len(lanes))] = np.nan
        else:
            arr[lanes] = np.nan

    lanes = np.arange(3 * m, 4 * m)
    kind = lanes % 4
    t_lo[lanes], t_hi[lanes] = (
        np.select([kind == 0, kind == 1, kind == 2], [1e-3, 5.0, -5.0], -1.0).astype(np.float32),
        np.select([kind == 0, kind == 1, kind == 2], [0.0, 5.0, -1.0], np.inf).astype(np.float32),
    )
    return o, d, t_lo, t_hi


CASES = {
    # name: (n_quads, n_spheres, PallasScene kwargs, forced (B1, B2, K) or ())
    "terrain8": (8, 0, {}, ()),  # single-level tree, brute-mode shadow rays
    "terrain40_vmem": (40, 0, {"force_stream": False}, ()),  # (16, 32, 32)
    "terrain40_stream": (40, 0, {"force_stream": True}, ()),  # kernel 2: HBM pages
    "terrain8_spheres": (8, 5, {}, ()),
    # chunks wider than a warp (K = 64, 128), as choose_shape gives past 2M triangles
    "terrain40_4x16x64": (40, 0, {}, (4, 16, 64)),
    "terrain40_2x16x128_spheres": (40, 3, {}, (2, 16, 128)),
}


def _setup(case, device="cpu", pallas=True):
    """(scene, PallasScene or None, CudaScene) over one WideBVH."""
    nq, n_sph, kw, shape = CASES[case]
    scene = make_terrain_scene(nq)
    sc, sr = _spheres(n_sph) if n_sph else (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    wb = build_wide_bvh(scene.tri_p, *shape)
    if pallas and jnp is None:
        pytest.skip("needs JAX for the Pallas reference")
    ps = PallasScene(wb, sc, sr, scene.num_triangles, **kw) if pallas else None
    cs = cuda_scene_from_wide_bvh(wb, sc, sr, scene.num_triangles, device)
    return scene, ps, cs


def _grazing(b1, b2):
    return np.minimum(np.minimum(b1, b2), 1.0 - b1 - b2) < 1e-4


def _compare(jax_out, port_out, any_hit):
    jt, jp, jb1, jb2, jh, jtests = [np.asarray(x) for x in jax_out]
    tt, tp, tb1, tb2, th, ttests = [x.numpy() for x in port_out]
    assert th.dtype == bool and tp.dtype == np.int32 and ttests.dtype == np.int32

    hit_eq = jh == th
    assert hit_eq.mean() >= 0.999
    tests_eq = jtests == ttests
    assert tests_eq.mean() >= 0.999
    assert abs(int(ttests.sum()) - int(jtests.sum())) <= 1e-3 * max(int(jtests.sum()), 1)
    if any_hit:
        assert (tp == -1).all()
        return
    both = jh & th
    # hit mismatches: the side that hits grazes an edge
    for i in np.nonzero(~hit_eq)[0]:
        b1, b2 = (jb1[i], jb2[i]) if jh[i] else (tb1[i], tb2[i])
        assert _grazing(b1, b2), f"lane {i}: hit mismatch off any edge"
    prim_eq = (jp == tp) | ~both
    assert prim_eq.mean() >= 0.999
    for i in np.nonzero(~prim_eq)[0]:
        assert abs(jt[i] - tt[i]) <= 1e-5 * abs(jt[i]) or _grazing(jb1[i], jb2[i]), f"lane {i}"
    sel = both & (jp == tp)
    if sel.any():
        rel_t = np.abs(jt[sel] - tt[sel]) / np.abs(jt[sel])
        d_b = np.maximum(np.abs(jb1[sel] - tb1[sel]), np.abs(jb2[sel] - tb2[sel]))
        assert (rel_t <= 1e-5).mean() >= 0.99 and rel_t.max() <= 1e-4
        assert (d_b <= 1e-5).mean() >= 0.99 and d_b.max() <= 1e-4


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas(case, any_hit):
    scene, ps, cs = _setup(case)
    o, d, t_lo, t_hi = _rays(scene)
    jax_out = intersect_pallas(
        ps, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_lo), jnp.asarray(t_hi),
        interpret=True, any_hit=any_hit,
    )
    port_out = ic.intersect(
        cs, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_lo),
        torch.from_numpy(t_hi), any_hit=any_hit,
    )
    _compare(jax_out, port_out, any_hit)
    # the brute-mode choice follows PallasScene: kernel C serves any-hit on tiny scenes
    assert cs.brute == ps.brute


def test_brute_closest_matches_pallas():
    """Kernel C's closest-hit flag against _make_brute_kernel(any_hit=False)."""
    scene, ps, cs = _setup("terrain8_spheres")
    o, d, t_lo, t_hi = _rays(scene, seed=1)
    jax_out = intersect_pallas(
        ps, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_lo), jnp.asarray(t_hi),
        interpret=True, brute=True,
    )
    port_out = ic.intersect(
        cs, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_lo),
        torch.from_numpy(t_hi), brute=True,
    )
    _compare(jax_out, port_out, any_hit=False)


def test_wrappers_take_plain_version_on_cpu_only():
    """CPU tensors run the plain version and launch nothing."""
    scene, _, cs = _setup("terrain8", pallas=False)
    o, d, t_lo, t_hi = (torch.from_numpy(x) for x in _rays(scene, 64, 64))
    ic.reset_launch_counts()
    ic.intersect(cs, o, d, t_lo, t_hi)
    ic.intersect(cs, o, d, t_lo, t_hi, any_hit=True)
    assert all(k.launches == 0 for k in ic.KERNELS.values())
    with pytest.raises(ValueError):
        ic.intersect(cs, o.double(), d, t_lo, t_hi)


def test_warp_walk_refuses_a_tree_it_cannot_read():
    """Kernels B and D read the tree as float4: the wrapper refuses a view off 16 bytes or of the wrong shape."""
    import dataclasses

    _, _, cs = _setup("terrain40_vmem", pallas=False)
    ic._check_warp_walk_tree(cs)
    shifted = torch.empty(cs.tri.numel() + 1)[1:].view_as(cs.tri)
    for bad in (dataclasses.replace(cs, tri=shifted), dataclasses.replace(cs, top=cs.top[:-1]),
                dataclasses.replace(cs, child=cs.child.t().contiguous().t()), dataclasses.replace(cs, k=0)):
        with pytest.raises(ValueError):
            ic._check_warp_walk_tree(bad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


RAY_SETS = {"mixed": _rays, "hard": _hard_rays}


@pytest.mark.gpu
@pytest.mark.parametrize("rays", list(RAY_SETS))
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_card(case, rays, cuda_device):
    """Each kernel equals its plain version on the card, lane for lane."""
    scene, _, cs = _setup(case, cuda_device, pallas=False)
    o, d, t_lo, t_hi = (torch.from_numpy(x).to(cuda_device) for x in RAY_SETS[rays](scene))
    runs = [
        ("A", lambda: ic.tree_closest_hit(cs, o, d, t_lo, t_hi), lambda: ic.tree_plain(cs, o, d, t_lo, t_hi, False)),
        ("B", lambda: ic.tree_any_hit(cs, o, d, t_lo, t_hi), lambda: ic.tree_plain(cs, o, d, t_lo, t_hi, True)),
    ]
    if cs.brute:
        runs.append(("C", lambda: ic.brute_hit(cs, o, d, t_lo, t_hi), lambda: ic.brute_plain(cs, o, d, t_lo, t_hi)))
    for key, kernel, plain in runs:
        before = ic.KERNELS[key].launches
        got = kernel()
        torch.cuda.synchronize()
        assert ic.KERNELS[key].launches == before + 1
        want = plain()
        for g, w in zip(got, want):
            assert torch.equal(g, w), key


@pytest.mark.gpu
@pytest.mark.parametrize("rays", list(RAY_SETS))
@pytest.mark.parametrize(
    "nq,n_sph,shape", [(40, 0, ()), (40, 5, ()), (40, 0, (4, 16, 64)), (40, 3, (2, 16, 128))],
    ids=["terrain40", "terrain40_spheres", "terrain40_4x16x64", "terrain40_2x16x128_spheres"],
)
def test_shade_kernel_matches_plain_on_card(nq, n_sph, shape, rays, cuda_device):
    """Kernel D equals its plain version on the card, and its walk equals kernel A's."""
    scene = make_terrain_scene(nq)
    sc, sr = _spheres(n_sph) if n_sph else (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    rows = np.concatenate(
        [np.asarray(scene.tri_n, np.float32).reshape(-1, 9),
         np.asarray(scene.tri_bsdf, np.float32).reshape(-1, 1)], axis=1,
    )
    cs = cuda_scene_from_wide_bvh(
        build_wide_bvh(scene.tri_p, *shape), sc, sr, scene.num_triangles, cuda_device, shade_rows=rows
    )
    assert cs.shade
    o, d, t_lo, t_hi = (torch.from_numpy(x).to(cuda_device) for x in RAY_SETS[rays](scene))
    before = ic.KERNELS["D"].launches
    got = ic.tree_closest_shade(cs, o, d, t_lo, t_hi)
    torch.cuda.synchronize()
    assert ic.KERNELS["D"].launches == before + 1
    want = ic.tree_plain(cs, o, d, t_lo, t_hi, False, shade=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, a in zip(got, ic.tree_closest_hit(cs, o, d, t_lo, t_hi)):
        assert torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,shape", [(64, (8, 32, 32)), (20, ())], ids=["terrain64_8x32x32", "terrain20"])
def test_mxu_kernel_matches_plain_on_card(nq, shape, cuda_device):
    """Kernel E equals its plain version on the card; it finds kernel A's hits."""
    scene = make_terrain_scene(nq)
    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    cs = cuda_scene_from_wide_bvh(
        build_wide_bvh(scene.tri_p, *shape), *none, scene.num_triangles, cuda_device, mxu=True
    )
    assert cs.mxu
    o, d, t_lo, t_hi = (torch.from_numpy(x).to(cuda_device) for x in _rays(scene))
    before = ic.KERNELS["E"].launches
    got = ic.tree_closest_mxu(cs, o, d, t_lo, t_hi)
    torch.cuda.synchronize()
    assert ic.KERNELS["E"].launches == before + 1
    for g, w in zip(got, ic.tree_plain(cs, o, d, t_lo, t_hi, False, mxu=True)):
        assert torch.equal(g, w)
    a = ic.tree_closest_hit(cs, o, d, t_lo, t_hi)
    hit = got[1] >= 0
    assert torch.equal(hit, a[1] >= 0) and torch.equal(got[1][hit], a[1][hit])
    assert torch.allclose(got[0][hit], a[0][hit], rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 1500], ids=["whole_tiles", "ragged"])
@pytest.mark.parametrize("tb", [2, 4])
def test_group_kernel_matches_plain_on_card(tb, n, cuda_device):
    """Kernel F (closest, any hit, shade) equals its plain version; its hits equal A's, B's and D's."""
    scene = make_terrain_scene(40)
    rows = np.concatenate(
        [np.asarray(scene.tri_n, np.float32).reshape(-1, 9),
         np.asarray(scene.tri_bsdf, np.float32).reshape(-1, 1)], axis=1,
    )
    sc, sr = _spheres(3)
    cs = cuda_scene_from_wide_bvh(
        build_wide_bvh(scene.tri_p), sc, sr, scene.num_triangles, cuda_device, shade_rows=rows
    )
    assert cs.shade and cs.b1 > 1 and not cs.stream
    o, d, t_lo, t_hi = (torch.from_numpy(x[:n]).to(cuda_device) for x in _rays(scene))
    t_lo = torch.where(torch.arange(n, device=cuda_device) % 5 == 0, 0.0, t_lo)  # occluded lanes stay charged
    for any_hit, shade, base in (
        (False, False, ic.tree_closest_hit), (True, False, ic.tree_any_hit), (False, True, ic.tree_closest_shade),
    ):
        before = ic.KERNELS["F"].launches
        got = ic.tree_group(cs, o, d, t_lo, t_hi, tb, any_hit=any_hit, shade=shade)
        torch.cuda.synchronize()
        assert ic.KERNELS["F"].launches == before + 1
        want = ic.tree_plain(cs, o, d, t_lo, t_hi, any_hit, shade=shade, top_batch=tb)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (any_hit, shade)
        ref = base(cs, o, d, t_lo, t_hi)
        for j, (g, w) in enumerate(zip(got, ref)):
            if j != 3:  # tests: the clip is fixed per group
                assert torch.equal(g, w), (any_hit, shade, j)
        if not any_hit:  # a clip fixed per group is never tighter than per top
            assert (got[3] >= ref[3]).all()
