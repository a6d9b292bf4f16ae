"""The port's halfedge mesh and Loop subdivision against the JAX package's, bit for bit.

``lens_flare_tpu_torch/scene/halfedge.py`` is a copy of
``lens_flare_tpu/scene/halfedge.py`` (float64 NumPy, the same arithmetic),
so every output must be equal, not close: the connectivity arrays, the
tombstones and the positions after each local operation (flip, split,
collapse, on seeded edge sequences), after each resampler (upsample,
downsample, resample), ``to_arrays``, the array path (``weld``,
``loop_subdivide``, ``subdivide_scene`` on a ``FlatScene``) and ``check``.

Meshes, all seeded: a jittered icosahedron (closed), a jittered 5x5 grid
(an open boundary), the Cornell box's meshes (``scene/writer.py:
cornell_box()``, read by each package's own loader: quads and an open box)
and a non-manifold fan.  Two faults of the reference are kept on purpose,
because parity is the port's measure of done (ROADMAP Queue 3):

- ``halfedge.py:67``: twins are paired on the undirected vertex pair
  only, so a closed mesh with one face wound the other way builds in both
  packages (``check`` then fails in both) instead of being refused;
- ``halfedge.py:700``: ``_loop_once`` gives an edge shared by more than
  two faces the interior rule over all its opposite vertices (weights
  summing past 1); the fan below shows both packages giving the same
  distorted point.

The port repairs ``halfedge.py:536`` with equal outputs: it keeps a live
face count instead of re-summing ``f_alive`` on every collapse, and
``downsample`` is held equal to the JAX one here.
"""

import dataclasses

import numpy as np
import pytest

from lens_flare_tpu.scene import build as j_build
from lens_flare_tpu.scene import halfedge as jh

from lens_flare_tpu_torch.scene import build
from lens_flare_tpu_torch.scene import halfedge as th
from lens_flare_tpu_torch.scene.writer import cornell_box, terrain_dae

STATE = ("h_vert", "h_next", "h_twin", "h_face", "h_edge", "h_alive", "v_half", "v_alive",
         "e_half", "e_alive", "f_half", "f_alive")


def _icosahedron(seed=0):
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= np.random.default_rng(seed).uniform(0.9, 1.1, (12, 1))
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    return v, f


def _grid(n=5, seed=1):
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = np.random.default_rng(seed).uniform(-0.2, 0.2, xs.shape)
    verts = np.stack([xs, ys, z], axis=-1).reshape(-1, 3).astype(float)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    return verts, np.array(faces)


@pytest.fixture(scope="module")
def cornell_scenes(tmp_path_factory):
    """The Cornell box file read by each package's loader: (port FlatScene, JAX FlatScene)."""
    path = cornell_box().write(tmp_path_factory.mktemp("halfedge") / "cornell.dae")
    return build.load_scene(path)[0], j_build.load_scene(path)[0]


def _cornell_block(scenes):
    """The box's open block (10 triangles; its other meshes are single quads), welded."""
    tri_p = scenes[0].tri_p[10:20]
    np.testing.assert_array_equal(tri_p, scenes[1].tri_p[10:20])
    return th.weld(np.asarray(tri_p, np.float64))


def _mesh_arrays(name, scenes):
    if name == "icosahedron":
        return _icosahedron()
    if name == "grid":
        return _grid()
    return _cornell_block(scenes)


def _assert_same_mesh(mine, ref):
    for k in STATE:
        assert list(getattr(mine, k)) == list(getattr(ref, k)), k
    np.testing.assert_array_equal(mine.pos, ref.pos)
    assert (mine.n_vertices, mine.n_edges, mine.n_faces) == (ref.n_vertices, ref.n_edges, ref.n_faces)
    pos, faces = mine.to_arrays()
    j_pos, j_faces = ref.to_arrays()
    np.testing.assert_array_equal(pos, j_pos)
    np.testing.assert_array_equal(faces, j_faces)


MESHES = ["icosahedron", "grid", "cornell_block"]


@pytest.mark.parametrize("name", MESHES)
def test_build_matches_jax(name, cornell_scenes):
    pos, faces = _mesh_arrays(name, cornell_scenes)
    mine, ref = th.HalfedgeMesh(pos, faces), jh.HalfedgeMesh(pos, faces)
    _assert_same_mesh(mine, ref)
    mine.check()
    for v in range(len(mine.v_alive)):
        assert mine.outgoing(v) == ref.outgoing(v)
        assert mine.is_boundary_vertex(v) == ref.is_boundary_vertex(v)


@pytest.mark.parametrize("op", ["flip_edge", "split_edge", "collapse_edge"])
@pytest.mark.parametrize("name", MESHES)
def test_local_operations_match_jax(name, op, cornell_scenes):
    """Eight seeded edges in turn (some rejected by the guards), the meshes compared after each."""
    pos, faces = _mesh_arrays(name, cornell_scenes)
    mine, ref = th.HalfedgeMesh(pos, faces), jh.HalfedgeMesh(pos, faces)
    rng = np.random.default_rng(len(name) * 7 + len(op))
    accepted = 0
    for _ in range(8):
        e = int(rng.integers(len(ref.e_alive)))
        if not ref.e_alive[e]:
            continue
        # split: (new vertex, along edges, cross edges); flip, collapse: the edge or the
        # surviving vertex, or None where a guard declined
        got, want = getattr(mine, op)(e), getattr(ref, op)(e)
        assert got == want
        accepted += want is not None
        _assert_same_mesh(mine, ref)
        mine.check()
    assert accepted > 0 or op == "collapse_edge"


@pytest.mark.parametrize("op", ["upsample", "downsample", "resample"])
@pytest.mark.parametrize("name", MESHES)
def test_resamplers_match_jax(name, op, cornell_scenes):
    pos, faces = _mesh_arrays(name, cornell_scenes)
    if op == "downsample":  # something to simplify: one Loop level first
        pos, faces = th.loop_subdivide(pos, faces)
    mine, ref = th.HalfedgeMesh(pos, faces), jh.HalfedgeMesh(pos, faces)
    getattr(mine, op)()
    getattr(ref, op)()
    _assert_same_mesh(mine, ref)
    mine.check()
    if op == "downsample":
        # the live face count (the port's repair of halfedge.py:536) is the tombstones' sum
        assert mine.n_faces == sum(mine.f_alive) < len(faces)


def test_upsample_equals_the_array_path():
    """The operation sequence and the vectorised path give the same triangles."""
    pos, faces = _icosahedron()
    m = th.HalfedgeMesh(pos, faces).upsample()
    a_pos, a_faces = th.loop_subdivide(pos, faces)
    canon = lambda p, f: sorted(map(tuple, np.sort(np.round(p[f], 9).reshape(len(f), 3, 3), axis=1).reshape(len(f), 9)))
    assert canon(*m.to_arrays()) == canon(a_pos, a_faces)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("name", MESHES)
def test_loop_subdivide_matches_jax(name, levels, cornell_scenes):
    pos, faces = _mesh_arrays(name, cornell_scenes)
    got = th.loop_subdivide(pos, faces, levels=levels)
    want = jh.loop_subdivide(pos, faces, levels=levels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert len(got[1]) == len(faces) * 4**levels


def test_weld_matches_jax(cornell_scenes):
    mine, ref = cornell_scenes
    rng = np.random.default_rng(3)
    soup = np.concatenate([mine.tri_p, mine.tri_p[:4] + rng.normal(0, 1e-9, (4, 3, 3)).astype(np.float32)])
    for g, w in zip(th.weld(soup), jh.weld(soup)):
        np.testing.assert_array_equal(g, w)


def test_nonmanifold_fan_matches_jax():
    """Three triangles on one edge: the halfedge build refuses it in both packages, and the array
    path gives both the same point, the reference's interior rule over three opposite vertices
    (weights 0.375 + 0.375 + 3 x 0.125; ROADMAP Queue 3, ``halfedge.py:700``, kept for parity)."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, -1, 0], [0.5, 0, 1]], float)
    faces = np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4]])
    for mod in (th, jh):
        with pytest.raises(ValueError, match="non-manifold"):
            mod.HalfedgeMesh(pos, faces)
    got, want = th.loop_subdivide(pos, faces), jh.loop_subdivide(pos, faces)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mid = got[0][len(pos)]  # the odd vertex of edge (0, 1), the first sorted edge
    np.testing.assert_allclose(mid, 0.375 * (pos[0] + pos[1]) + 0.125 * pos[2:].sum(axis=0))


def test_inconsistent_winding_builds_in_both():
    """A tetrahedron with one face wound the other way: paired on the undirected key, it builds in
    both packages (ROADMAP Queue 3, ``halfedge.py:67``, kept for parity) and fails ``check``."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    faces = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])
    faces[1] = faces[1][::-1]
    mine, ref = th.HalfedgeMesh(pos, faces), jh.HalfedgeMesh(pos, faces)
    _assert_same_mesh(mine, ref)
    for m in (mine, ref):
        with pytest.raises(AssertionError):
            m.check()


@pytest.mark.parametrize("scene", ["cornell", "terrain"])
@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_scene_matches_jax(scene, levels, cornell_scenes, tmp_path):
    if scene == "cornell":
        mine, ref = cornell_scenes
    else:
        path = terrain_dae(4).write(tmp_path / "terrain.dae")
        mine, ref = build.load_scene(path)[0], j_build.load_scene(path)[0]
    got, want = th.subdivide_scene(mine, levels), jh.subdivide_scene(ref, levels)
    assert got.num_triangles == want.num_triangles == mine.num_triangles * 4**levels
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
            assert g.dtype == w.dtype, f.name
    # the input is left as it was
    assert mine.num_triangles == ref.num_triangles
