"""Kernel D (closest hit plus the winner's shading row) against the Pallas shade kernel.

The JAX side runs ``intersect_pallas(PallasScene(..., shade_rows=...,
interpret=True), ..., return_shade=True)``; the port runs kernel D's plain
version (what ``intersect(..., return_shade=True)`` takes for CPU tensors)
over the same ``WideBVH``.

Tolerances and why:
- hit masks, prims, per-lane test counts and shading rows equal on every
  lane (where a sphere wins, both keep the row of the best triangle behind it);
- t within 1e-4 relative plus 1e-6 absolute, and barycentrics within 1e-4,
  on every hit lane: the hard bound of the kernel-A tests in
  test_torch_intersect.py.  XLA:CPU contracts the Moller-Trumbore dot
  products into fused multiply-adds and the port rounds every product
  (ROADMAP Queue 3); that difference is a few ulps of the products'
  operands, scene coordinates of order 10 (an ulp of 10 is 9.5e-7), hence
  the absolute term for bounce rays that re-hit at t ~ 1e-4.  D's first
  four outputs equal kernel A's bit for bit, and the Pallas shade kernel's
  equal the plain Pallas kernel's, so these differences are exactly A's
  against Pallas.  On these ray sets they reach 5.3e-5 in a barycentric (5%
  of camera hits on terrain 64 above 1e-5: the orbit camera sees the
  terrain at grazing angles) and 1.4e-8 absolute at t = 1.5e-4 (9.8e-5
  relative) on a bounce ray.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.accel.wide import build_wide_bvh
from lens_flare_tpu.integrator import path as jpath
from lens_flare_tpu.ops.intersect import finalize_hit as j_finalize_hit
from lens_flare_tpu.ops.intersect_pallas import PallasScene, intersect_pallas
from lens_flare_tpu.renderer import Renderer as JaxRenderer
from lens_flare_tpu.scene.camera import Camera
from lens_flare_tpu.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.convert import (
    camera_params_from_numpy,
    cuda_scene_from_wide_bvh,
    scene_bundle_from_numpy,
)
from lens_flare_tpu_torch.integrator import path as tpath
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.ops.intersect import finalize_hit
from lens_flare_tpu_torch.scene.camera import generate_rays


def _shade_rows(scene):
    n = scene.num_triangles
    return np.concatenate(
        [np.asarray(scene.tri_n, np.float32).reshape(n, 9),
         np.asarray(scene.tri_bsdf, np.float32).reshape(n, 1)], axis=1,
    )


def _spheres(n, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(1, 3, n)
    return c, rng.uniform(0.5, 2.0, n).astype(np.float32)


def _setup(nq, n_sph=0, **kw):
    scene = make_terrain_scene(nq)
    sc, sr = _spheres(n_sph) if n_sph else (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    wb = build_wide_bvh(scene.tri_p)
    rows = _shade_rows(scene)
    ps = PallasScene(wb, sc, sr, scene.num_triangles, shade_rows=rows, interpret=True, **kw)
    cs = cuda_scene_from_wide_bvh(wb, sc, sr, scene.num_triangles, shade_rows=rows, **kw)
    return scene, ps, cs


def _camera(scene, w=64, h=48):
    cam = Camera()
    center = (scene.bbox_min + scene.bbox_max) / 2
    extent = np.linalg.norm(scene.bbox_max - scene.bbox_min)
    cam.place(center, math.pi / 3, math.pi / 4, extent, extent / 10, extent * 10)
    cam.screen_w, cam.screen_h = w, h
    return cam


def _rays(scene, cs, n=1024, seed=0):
    """{camera, bounce}: (o, d, t_lo, t_hi) numpy arrays; bounce rays leave the camera hits."""
    rng = np.random.default_rng(seed)
    p = camera_params_from_numpy(_camera(scene).params())
    x, y = (torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32) for _ in range(2))
    o, d = generate_rays(p, x, y)
    o = o.contiguous()
    t_lo = torch.full((n,), 1e-3)
    t_hi = torch.full((n,), 1e30)
    t_hi[torch.as_tensor(rng.uniform(size=n) < 0.1)] = 0.0  # dead lanes
    t, _, b1, b2, hit, _ = ic.intersect(cs, o, d, t_lo, t_hi)
    nrm = np.tile(np.float32([0, 0, 1]), (n, 1))
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w = nrm + w / np.linalg.norm(w, axis=1, keepdims=True)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    hp = (o + d * torch.where(hit, t, 0.0)[:, None]).numpy()
    bo = hp + 1e-4 * nrm * np.maximum(np.abs(hp).max(axis=1, keepdims=True), 1.0)
    b_hi = np.where(hit.numpy(), 1e30, 0.0).astype(np.float32)
    cam = (o.numpy(), d.numpy(), t_lo.numpy(), t_hi.numpy())
    return {"camera": cam, "bounce": (bo.astype(np.float32), w, np.full(n, 1e-5, np.float32), b_hi)}


def _run_both(ps, cs, rays):
    jo = intersect_pallas(ps, *(jnp.asarray(a) for a in rays), interpret=True, return_shade=True)
    to = ic.intersect(cs, *(torch.from_numpy(np.ascontiguousarray(a)) for a in rays), return_shade=True)
    return [np.asarray(a) for a in jo], [a.numpy() for a in to]


def _compare(jo, to):
    jt, jp, jb1, jb2, jh, jtests, jrows = jo
    tt, tp, tb1, tb2, th, ttests, trows = to
    assert trows.shape == (len(tt), 10) and jrows.shape == (10, len(jt))
    assert (jh == th).all() and (jp == tp).all() and (jtests == ttests).all()
    assert th.sum() > 50
    np.testing.assert_allclose(tt[th], jt[th], rtol=1e-4, atol=1e-6)
    d_b = np.maximum(np.abs(jb1[th] - tb1[th]), np.abs(jb2[th] - tb2[th]))
    assert d_b.max() <= 1e-4
    assert (trows == jrows.T).all()


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("nq", [40, 64], ids=["terrain40", "terrain64"])
def test_plain_d_matches_pallas_shade(nq, kind):
    scene, ps, cs = _setup(nq)
    assert cs.shade and ps.shade
    rays = _rays(scene, cs)[kind]
    jo, to = _run_both(ps, cs, rays)
    _compare(jo, to)
    # the same walk as kernel A (chunk batch 1 on these trees), on both sides
    a = ic.intersect(cs, *(torch.from_numpy(np.ascontiguousarray(x)) for x in rays))
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(a, to[:6]))
    ja = intersect_pallas(ps, *(jnp.asarray(x) for x in rays), interpret=True)
    assert all(np.array_equal(np.asarray(x), y) for x, y in zip(ja, jo[:6]))
    # rows of triangle hits are the triangles' own shading rows
    hit_tri = to[4]
    assert (to[6][hit_tri] == _shade_rows(scene)[to[1][hit_tri]]).all()
    assert (to[6][~hit_tri] == 0).all()


def test_sphere_keeps_best_triangle_row():
    """Where a sphere wins, the row is the best triangle's (intersect_pallas.py:843-847)."""
    scene, ps, cs = _setup(40, n_sph=6)
    jo, to = _run_both(ps, cs, _rays(scene, cs, seed=2)["camera"])
    _compare(jo, to)
    t, prim, b1, b2, hit, _, rows = to
    sph_won = hit & (prim >= scene.num_triangles)
    stale = sph_won & (rows != 0).any(axis=1)
    assert stale.sum() > 0, "no lane where a sphere hides a triangle"


def test_finalize_hit_with_rows_matches_jax():
    """finalize_hit(shade_rows=...) against the JAX finalize_hit(shade_cm=...)."""
    scene = make_terrain_scene(40)
    sc, sr = _spheres(6)
    scene.sph_center, scene.sph_radius = sc, sr
    scene.sph_bsdf = np.zeros(6, np.int32)
    jr = JaxRenderer(use_pallas=False, width=32, height=24)
    jr.load_flat_scene(scene)
    wb = build_wide_bvh(scene.tri_p)
    rows = _shade_rows(scene)
    ps = PallasScene(wb, sc, sr, scene.num_triangles, shade_rows=rows, interpret=True)
    cs = cuda_scene_from_wide_bvh(wb, sc, sr, scene.num_triangles, shade_rows=rows)
    bundle = scene_bundle_from_numpy(jr.bundle.scene, jr.bundle.bsdfs, jr.bundle.lights, cs)
    rays = _rays(scene, cs, seed=2)["camera"]
    jo, to = _run_both(ps, cs, rays)
    t, prim, b1, b2, hit, _, trows = (torch.from_numpy(a) for a in to)
    o, d = torch.from_numpy(rays[0]), torch.from_numpy(rays[1])
    got = finalize_hit(bundle.scene, o, d, t, prim, b1, b2, hit, shade_rows=trows)
    # the same raw hits on both sides, each side's own rows (equal, see _compare)
    want = j_finalize_hit(
        jr.bundle.scene, *(jnp.asarray(a) for a in (rays[0], rays[1], *to[:5])), shade_cm=jnp.asarray(jo[6])
    )
    sph_won = hit & (prim >= scene.num_triangles)
    assert sph_won.sum() > 0
    assert (got.bsdf.numpy() == np.asarray(want.bsdf)).all()
    sel = hit.numpy()
    np.testing.assert_allclose(got.n.numpy()[sel], np.asarray(want.n)[sel], atol=1e-5)
    # the gathered path gives the same Hit
    gathered = finalize_hit(bundle.scene, o, d, t, prim, b1, b2, hit)
    assert torch.equal(gathered.bsdf, got.bsdf) and torch.equal(gathered.n, got.n)


@pytest.mark.parametrize(
    "nq,kw",
    [(8, {}), (40, {}), (256, {}), (280, {}), (40, {"force_stream": True}),
     (40, {"force_stream": True, "stream_shade": True}), (280, {"force_stream": True, "stream_shade": True}),
     (40, {"force_stream": False})],
    ids=["t8", "t40", "t256", "t280", "t40_stream", "t40_stream_shade", "t280_stream_shade", "t40_vmem"],
)
def test_shade_routing_matches_pallas_scene(nq, kw):
    scene = make_terrain_scene(nq)
    wb = build_wide_bvh(scene.tri_p)
    rows = _shade_rows(scene)
    e = np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    ps = PallasScene(wb, *e, scene.num_triangles, shade_rows=rows, **kw)
    cs = cuda_scene_from_wide_bvh(wb, *e, scene.num_triangles, shade_rows=rows, **kw)
    assert (cs.shade, cs.stream, cs.brute) == (ps.shade, ps.stream, ps.brute)
    # without the table no scene takes kernel D
    assert not cuda_scene_from_wide_bvh(wb, *e, scene.num_triangles, **kw).shade
    expected = {8: False, 40: True, 256: True, 280: False}
    if not kw:
        assert cs.shade == expected[nq]


def test_return_shade_raises_where_pallas_does():
    scene, ps, cs = _setup(40)
    rays = [torch.from_numpy(a) for a in _rays(scene, cs, n=64)["camera"]]
    with pytest.raises(ValueError):
        ic.intersect(cs, *rays, any_hit=True, return_shade=True)
    small, _, cs8 = _setup(8)
    rays8 = [torch.from_numpy(a) for a in _rays(small, cs8, n=64)["camera"]]
    with pytest.raises(ValueError):
        ic.intersect(cs8, *rays8, return_shade=True)
    with pytest.raises(ValueError):
        intersect_pallas(_setup(8)[1], *(jnp.asarray(a.numpy()) for a in rays8), return_shade=True)
    ic.reset_launch_counts()
    ic.intersect(cs, *rays, return_shade=True)
    assert ic.KERNELS["D"].launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("coherent", [False, True], ids=["bounce", "coherent"])
@pytest.mark.parametrize("stream", [False, True], ids=["vmem", "stream_shade"])
def test_trace_closest_matches_jax(coherent, stream, monkeypatch):
    """The port's trace_closest against the JAX one with an interpret-mode PallasScene."""
    routes = []
    plain = ic.tree_plain

    def spy(*args, shade=False):
        routes.append("D" if shade else "A")
        return plain(*args, shade=shade)

    monkeypatch.setattr(ic, "tree_plain", spy)
    scene = make_terrain_scene(40)
    jr = JaxRenderer(use_pallas=False, width=32, height=24)
    jr.load_flat_scene(scene)
    wb = build_wide_bvh(scene.tri_p)
    rows = _shade_rows(scene)
    e = np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    kw = {"force_stream": True, "stream_shade": True} if stream else {}
    ps = PallasScene(wb, *e, scene.num_triangles, shade_rows=rows, interpret=True, **kw)
    cs = cuda_scene_from_wide_bvh(wb, *e, scene.num_triangles, shade_rows=rows, **kw)
    assert ps.shade and cs.shade and cs.stream == stream
    jb = jr.bundle._replace(pscene=ps)
    tb = scene_bundle_from_numpy(jr.bundle.scene, jr.bundle.bsdfs, jr.bundle.lights, cs)
    rays = _rays(scene, cs, n=512)["bounce" if not coherent else "camera"]
    want, jst = jpath.trace_closest(jb, *(jnp.asarray(a) for a in rays), coherent=coherent)
    got, st = tpath.trace_closest(tb, *(torch.from_numpy(np.ascontiguousarray(a)) for a in rays), coherent=coherent)
    assert (got.hit.numpy() == np.asarray(want.hit)).all()
    assert (got.prim.numpy() == np.asarray(want.prim)).all()
    assert (got.bsdf.numpy() == np.asarray(want.bsdf)).all()
    sel = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[sel], np.asarray(want.t)[sel], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.n.numpy()[sel], np.asarray(want.n)[sel], atol=1e-5)
    np.testing.assert_allclose(st.numpy()[:2], np.asarray(jst)[:2])
    # camera wavefronts on stream_shade scenes keep kernel A and the gather
    assert routes[-1] == ("A" if (coherent and stream) else "D")
