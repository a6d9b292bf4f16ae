"""Scene tables on the device and hit finalization.

Counterpart of ``lens_flare_tpu/ops/intersect.py``: ``SceneArrays``,
``Hit``, ``scene_to_device`` (``:64``) and ``finalize_hit`` (``:282``),
with :func:`bvh_to_device`, which packs a binary BVH for kernel G (and
:func:`unpack_bvh`, its inverse, for tests).  The
XLA traversal ``_make_traverse`` (``:152-259``) is kernel G and its plain
version ``bvh_walk_plain``, both in
:mod:`lens_flare_tpu_torch.ops.intersect_cuda` beside kernels A-F.
Scenes the cluster tree holds trace through kernels A-D; scenes past its
capacity, or a renderer asked for it, walk the binary BVH.
``finalize_hit`` gathers the winner's shading row here, unless kernel D
already returned it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.bvh import FlatBVH
from .intersect_cuda import BVH_LEAF_BITS, BVH_MAX_LEAF, BvhArrays


class SceneArrays(NamedTuple):
    """Shading tables (all tensors on one device); the geometry lives in CudaScene."""

    tri_shade: torch.Tensor  # (T, 10) [corner normals (9) | bsdf id]
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_bsdf: torch.Tensor  # (S,) int32


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) hit distance
    prim: torch.Tensor  # (N,) primitive id (triangles then spheres), -1 on miss
    bsdf: torch.Tensor  # (N,) bsdf row id
    n: torch.Tensor  # (N, 3) shading normal
    hit: torch.Tensor  # (N,) bool


def shade_rows(flat_scene) -> np.ndarray:
    """(T, 10) float32 [corner normals (9) | bsdf id] per triangle (``renderer.py:183-193``)."""
    n_t = len(flat_scene.tri_p)
    return np.concatenate(
        [
            np.asarray(flat_scene.tri_n, np.float32).reshape(n_t, 9),
            np.asarray(flat_scene.tri_bsdf, np.float32).reshape(n_t, 1),
        ],
        axis=1,
    )


def scene_to_device(flat_scene, device) -> SceneArrays:
    """Upload a host ``FlatScene`` (:mod:`lens_flare_tpu_torch.scene.build`)."""

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SceneArrays(
        tri_shade=f32(shade_rows(flat_scene)),
        sph_center=f32(np.asarray(flat_scene.sph_center).reshape(-1, 3)),
        sph_radius=f32(flat_scene.sph_radius),
        sph_bsdf=torch.as_tensor(np.asarray(flat_scene.sph_bsdf, np.int32), device=device),
    )


def bvh_to_device(flat_scene, bvh, device) -> BvhArrays:
    """Pack a ``FlatBVH`` over ``flat_scene``'s triangles then spheres for kernel G, and upload it.

    - ``root``: the root's box and its link (below);
    - ``nodes``: one 64-byte record per node the walk treats as interior
      (``node_count == 0``), in the tree's order: both children's boxes,
      both children's links and both children's node ids.  A link is the
      child's record index, or ``~(start << 3 | count)`` for a leaf, its
      range of rows; a missing child (only the empty tree's root has none)
      gets NaN bounds, which no slab test passes, and link -1;
    - ``rows``: one 48-byte row per primitive in ``prim_order`` order, so a
      leaf's rows are contiguous: triangles ``[p0 | e1 | e2 | id]``, spheres
      ``[center | radius | 0 x 7 | id]``, the id's int32 bits in word 11.

    Edges are float32 differences of float32 corners, as the JAX package's
    ``scene_to_device`` takes them (``intersect.py:75-77``).  Vectorised
    NumPy, no loop over nodes.
    """
    tri_p = np.asarray(flat_scene.tri_p, np.float32).reshape(-1, 3, 3)
    n_t, n_s = len(tri_p), len(flat_scene.sph_center)
    count = np.asarray(bvh.node_count, np.int64)
    order = np.asarray(bvh.prim_order, np.int64)
    if count.max(initial=0) > BVH_MAX_LEAF or len(order) >= 1 << (31 - BVH_LEAF_BITS):
        raise ValueError(f"kernel G takes leaves of at most {BVH_MAX_LEAF} primitives and fewer than "
                         f"2**{31 - BVH_LEAF_BITS} primitives; got {count.max()} and {len(order)}")
    prim = np.zeros((n_t + n_s, 12), np.float32)
    prim[:n_t, 0:3] = tri_p[:, 0]
    prim[:n_t, 3:6] = tri_p[:, 1] - tri_p[:, 0]
    prim[:n_t, 6:9] = tri_p[:, 2] - tri_p[:, 0]
    prim[n_t:, 0:3] = np.asarray(flat_scene.sph_center, np.float32).reshape(-1, 3)
    prim[n_t:, 3] = np.asarray(flat_scene.sph_radius, np.float32)
    prim.view(np.int32)[:, 11] = np.arange(n_t + n_s)
    rows = prim[order] if len(order) else np.zeros((1, 12), np.float32)
    del prim

    node_min = np.asarray(bvh.node_min, np.float32)
    node_max = np.asarray(bvh.node_max, np.float32)
    start = np.asarray(bvh.node_start, np.int64)
    inner = np.flatnonzero(count == 0)
    record = np.full(len(count), -1, np.int64)
    record[inner] = np.arange(len(inner))
    link = np.where(count > 0, ~((start << BVH_LEAF_BITS) | count), record)
    nodes = np.full((max(len(inner), 1), 16), np.nan, np.float32)
    words = nodes.view(np.int32)
    words[:, 12:16] = -1
    for side, child in enumerate((np.asarray(bvh.node_left)[inner], np.asarray(bvh.node_right)[inner])):
        has = np.flatnonzero(child >= 0)
        c = child[has]
        nodes[has, 6 * side : 6 * side + 3] = node_min[c]
        nodes[has, 6 * side + 3 : 6 * side + 6] = node_max[c]
        words[has, 12 + side] = link[c]
        words[has, 14 + side] = c
    root = np.zeros(8, np.float32)
    root[0:3], root[3:6] = node_min[0], node_max[0]
    root.view(np.int32)[6] = link[0]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return BvhArrays(
        root=t(root), nodes=t(nodes), rows=t(rows), num_tris=n_t, n_spheres=n_s,
        num_nodes=len(count), max_depth=int(bvh.max_depth),
    )


def unpack_bvh(bv: BvhArrays):
    """The ``FlatBVH`` and the scene-order rows that :func:`bvh_to_device` packed into ``bv``.

    Returns (bvh, tri, sph): ``tri`` (T, 12) ``[p0 | e1 | e2 | 0 x 3]`` and
    ``sph`` (S, 8) ``[center | radius | 0 x 4]``, the rows kernel G read in
    scene order before the packing.  An interior node's ``node_start`` is
    its leftmost leaf's (the walk never reads it): the first leaf at or
    after it, since the builders number nodes depth first, left child first.
    """
    root = bv.root.cpu().numpy()
    nodes = bv.nodes.cpu().numpy()
    rows = bv.rows.cpu().numpy()
    m = bv.num_nodes
    words, root_link = nodes.view(np.int32), int(root.view(np.int32)[6])
    node_min = np.zeros((m, 3), np.float32)
    node_max = np.zeros((m, 3), np.float32)
    left = np.full(m, -1, np.int32)
    right = np.full(m, -1, np.int32)
    start = np.zeros(m, np.int64)
    count = np.zeros(m, np.int64)
    node_min[0], node_max[0] = root[0:3], root[3:6]
    # every node's link (the root's, and each child's in its parent's record), and the record's node
    ids = np.concatenate([[0], words[:, 14], words[:, 15]]).astype(np.int64)
    links = np.concatenate([[root_link], words[:, 12], words[:, 13]]).astype(np.int64)
    real = ids >= 0
    ids, links = ids[real], links[real]
    leaf = links < 0
    start[ids[leaf]] = ~links[leaf] >> BVH_LEAF_BITS
    count[ids[leaf]] = ~links[leaf] & ((1 << BVH_LEAF_BITS) - 1)
    node_of = np.full(len(nodes), -1, np.int64)
    node_of[links[~leaf]] = ids[~leaf]
    for side, out in enumerate((left, right)):
        child = words[:, 14 + side]
        has = (node_of >= 0) & (child >= 0)
        out[node_of[has]] = child[has]
        node_min[child[has]] = nodes[has, 6 * side : 6 * side + 3]
        node_max[child[has]] = nodes[has, 6 * side + 3 : 6 * side + 6]
    leaves = np.flatnonzero(count > 0)
    if len(leaves):
        first = leaves[np.minimum(np.searchsorted(leaves, np.arange(m)), len(leaves) - 1)]
        start = np.where(count > 0, start, start[first])
    n_p = bv.num_tris + bv.n_spheres
    prim_order = rows.view(np.int32)[:n_p, 11].copy()
    tri = np.zeros((bv.num_tris, 12), np.float32)
    sph = np.zeros((bv.n_spheres, 8), np.float32)
    is_tri = prim_order < bv.num_tris
    tri[prim_order[is_tri], 0:9] = rows[:n_p][is_tri, 0:9]
    sph[prim_order[~is_tri] - bv.num_tris, 0:4] = rows[:n_p][~is_tri, 0:4]
    bvh = FlatBVH(node_min=node_min, node_max=node_max, node_left=left, node_right=right,
                  node_start=start.astype(np.int32), node_count=count.astype(np.int32),
                  prim_order=prim_order, max_depth=bv.max_depth)
    return bvh, tri, sph


def _normalize(v: torch.Tensor) -> torch.Tensor:
    nrm = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    return v / torch.clamp_min(nrm, 1e-30)[:, None]


def finalize_hit(scene: SceneArrays, o, d, t, prim, b1, b2, found, shade_rows=None) -> Hit:
    """Raw trace results -> Hit with shading normals and bsdf rows.

    Triangles get the barycentric-interpolated unit normal
    (``triangle.cpp:104-108``), spheres the geometric normal.
    ``shade_rows``: the (N, 10) winner rows kernel D returned; they replace
    the table gather (``lens_flare_tpu/ops/intersect.py:300-303``).
    """
    num_tris = scene.tri_shade.shape[0]
    n_sph = scene.sph_center.shape[0]
    is_tri = (prim >= 0) & (prim < num_tris)
    tri_idx = torch.clamp(prim, 0, max(num_tris - 1, 0)).long()
    sph_idx = torch.clamp(prim - num_tris, 0, max(n_sph - 1, 0)).long()

    if num_tris > 0:
        rows = scene.tri_shade[tri_idx] if shade_rows is None else shade_rows  # (N, 10)
        n0, n1, n2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        b0 = 1.0 - b1 - b2
        n_tri = b0[:, None] * n0 + b1[:, None] * n1 + b2[:, None] * n2
        n_tri = _normalize(n_tri)
        bsdf_tri = rows[:, 9].to(torch.int32)
    else:
        n_tri = torch.zeros_like(o)
        bsdf_tri = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)

    if n_sph > 0:
        p_hit = o + d * t[:, None]
        n_s = _normalize(p_hit - scene.sph_center[sph_idx])
        bsdf_sph = scene.sph_bsdf[sph_idx]
    else:
        n_s = torch.zeros_like(o)
        bsdf_sph = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)

    n = torch.where(is_tri[:, None], n_tri, n_s)
    bsdf = torch.where(is_tri, bsdf_tri, bsdf_sph)
    return Hit(t=t, prim=prim, bsdf=bsdf, n=n, hit=found)
