"""Scene tables on the device and hit finalization.

Counterpart of ``lens_flare_tpu/ops/intersect.py``: ``SceneArrays``,
``Hit``, ``scene_to_device`` (``:64``) and ``finalize_hit`` (``:282``),
with :func:`bvh_to_device`, which uploads a binary BVH for kernel G.  The
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

from .intersect_cuda import BvhArrays


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
    """Upload a ``FlatBVH`` over ``flat_scene``'s triangles then spheres.

    Edges are float32 differences of float32 corners, as the JAX package's
    ``scene_to_device`` takes them (``intersect.py:75-77``).
    """
    tri_p = np.asarray(flat_scene.tri_p, np.float32)
    n_t, n_s = len(tri_p), len(flat_scene.sph_center)
    tri = np.zeros((max(n_t, 1), 12), np.float32)
    if n_t:
        tri[:n_t, 0:3] = tri_p[:, 0]
        tri[:n_t, 3:6] = tri_p[:, 1] - tri_p[:, 0]
        tri[:n_t, 6:9] = tri_p[:, 2] - tri_p[:, 0]
    sph = np.zeros((max(n_s, 1), 8), np.float32)
    if n_s:
        sph[:n_s, 0:3] = np.asarray(flat_scene.sph_center, np.float32).reshape(-1, 3)
        sph[:n_s, 3] = np.asarray(flat_scene.sph_radius, np.float32)
    box = np.zeros((bvh.num_nodes, 8), np.float32)
    box[:, 0:3] = bvh.node_min
    box[:, 3:6] = bvh.node_max
    link = np.stack([bvh.node_left, bvh.node_right, bvh.node_start, bvh.node_count], axis=1)
    order = np.asarray(bvh.prim_order, np.int32)
    if order.size == 0:
        order = np.zeros(1, np.int32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return BvhArrays(
        node_box=t(box, np.float32), node_link=t(link, np.int32), prim_order=t(order, np.int32),
        tri=t(tri, np.float32), sph=t(sph, np.float32),
        num_tris=n_t, n_spheres=n_s, max_depth=int(bvh.max_depth),
    )


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
