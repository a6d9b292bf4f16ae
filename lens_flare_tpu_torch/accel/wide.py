"""Two-level wide BVH ("cluster tree") that the trace kernels walk.

Counterpart of ``lens_flare_tpu/accel/wide.py``.  The scene is carved into
B1 top clusters x B2 child clusters x K triangles by recursive largest-axis
median splits (balanced by construction).  The same triangles and shape give
the same arrays as the JAX package's builder: the native builder
(``native/builder.cpp``) matches its native builder and the NumPy builder
here matches its NumPy one.

Layout (all padded, f32):
- ``top_boxes``   (B1, 8)         [min.xyz, max.xyz, pad, pad]
- ``child_boxes`` (B1*B2, 8)
- ``tri_soa``     (B1*B2*K, 12)   [p0.xyz, e1.xyz, e2.xyz, pad3]
- ``tri_id``      (B1*B2*K,)      original primitive id, -1 for padding

Padding triangles have e1 = e2 = 0, so a zero determinant: never hit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WideBVH:
    top_boxes: np.ndarray  # (B1, 8) f32
    child_boxes: np.ndarray  # (B1*B2, 8) f32
    tri_soa: np.ndarray  # (B1*B2*K, 12) f32
    tri_id: np.ndarray  # (B1*B2*K,) int32
    b1: int
    b2: int
    k: int


def _median_partition(order, centroids, n_parts):
    """Recursively split `order` into n_parts balanced chunks by median splits."""
    chunks = [order]
    while len(chunks) < n_parts:
        new_chunks = []
        for idx in chunks:
            if len(idx) <= 1:
                new_chunks.append(idx)
                new_chunks.append(idx[:0])
                continue
            c = centroids[idx]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order_ax = np.argsort(c[:, axis], kind="stable")
            half = (len(idx) + 1) // 2
            new_chunks.append(idx[order_ax[:half]])
            new_chunks.append(idx[order_ax[half:]])
        chunks = new_chunks
    return chunks


def choose_shape(n_tris: int) -> tuple[int, int, int]:
    """(B1, B2, K) sized to the scene: the first with capacity B1*B2*K >= n_tris.

    The ladder is the JAX package's (``accel/wide.py:52-87``): single-level
    trees for small scenes, K = 32 leaves, B2 = 128 past 262k triangles.
    """
    for b1, b2, k in [
        (1, 16, 8),
        (1, 32, 16),
        (1, 64, 32),
        (16, 32, 32),
        (32, 64, 32),
        (64, 64, 32),
        (64, 128, 32),
        (128, 128, 32),
        (256, 128, 32),
        (512, 128, 32),
        (512, 128, 64),
        (512, 128, 128),
        (512, 128, 256),
    ]:
        if b1 * b2 * k >= max(n_tris, 1):
            return b1, b2, k
    return 512, 128, 256


# the largest tree of choose_shape's ladder: past it a cluster overflows K
MAX_TRIS = 512 * 128 * 256


def check_capacity(n_tris: int) -> None:
    """Raise for a scene the cluster tree cannot hold (more than ``MAX_TRIS`` triangles)."""
    if n_tris > MAX_TRIS:
        raise ValueError(
            f"{n_tris:,} triangles: the cluster tree holds at most {MAX_TRIS:,} (512*128*256); "
            "such scenes take the binary-BVH walk (kernel G, use_wide_tree=None or False)"
        )


def takes_wide_tree(n_tris: int, use_wide_tree: bool | None = None) -> bool:
    """Whether a scene of ``n_tris`` triangles is traced on the cluster tree (kernels A-D).

    The counterpart of the JAX ``Renderer``'s ``use_pallas`` choice
    (``lens_flare_tpu/renderer.py:167-176``): None takes the cluster tree up
    to its capacity and the binary-BVH walk (kernel G, the JAX package's XLA
    walk) past it; False forces the binary walk; True forces the cluster
    tree and raises past its capacity.
    """
    if use_wide_tree is None:
        return n_tris <= MAX_TRIS
    if use_wide_tree:
        check_capacity(n_tris)
    return bool(use_wide_tree)


def build_wide_bvh(tri_p: np.ndarray, b1: int | None = None, b2: int | None = None, k: int | None = None) -> WideBVH:
    """tri_p: (T, 3, 3) triangle corners.  The C++ builder where g++ builds it, else NumPy."""
    n = len(tri_p)
    if b1 is None:
        b1, b2, k = choose_shape(n)

    if n > 0:
        from .native import build_wide_native

        built = build_wide_native(np.asarray(tri_p, np.float32), b1, b2, k)
        if built is not None:
            return built
    return _build_wide_numpy(tri_p, b1, b2, k)


def _build_wide_numpy(tri_p, b1: int, b2: int, k: int) -> WideBVH:
    n = len(tri_p)
    tri_p = np.asarray(tri_p, np.float64)
    top_boxes = np.zeros((b1, 8), np.float32)
    child_boxes = np.zeros((b1 * b2, 8), np.float32)
    tri_soa = np.zeros((b1 * b2 * k, 12), np.float32)
    tri_id = np.full(b1 * b2 * k, -1, np.int32)
    if n == 0:
        return WideBVH(top_boxes, child_boxes, tri_soa, tri_id, b1, b2, k)

    box_min = tri_p.min(axis=1)
    box_max = tri_p.max(axis=1)
    centroids = (box_min + box_max) * 0.5
    top_chunks = _median_partition(np.arange(n), centroids, b1)

    # empty boxes: min > max so the slab test always fails
    top_boxes[:, 0:3] = 1.0
    top_boxes[:, 3:6] = -1.0
    child_boxes[:, 0:3] = 1.0
    child_boxes[:, 3:6] = -1.0

    for t, chunk in enumerate(top_chunks[:b1]):
        if len(chunk) == 0:
            continue
        top_boxes[t, 0:3] = box_min[chunk].min(axis=0)
        top_boxes[t, 3:6] = box_max[chunk].max(axis=0)
        sub_chunks = _median_partition(chunk, centroids, b2)
        for c, sub in enumerate(sub_chunks[:b2]):
            if len(sub) == 0:
                continue
            if len(sub) > k:
                raise ValueError(f"cluster overflow: {len(sub)} > K={k}; increase capacity")
            node = t * b2 + c
            child_boxes[node, 0:3] = box_min[sub].min(axis=0)
            child_boxes[node, 3:6] = box_max[sub].max(axis=0)
            base = node * k
            for s, prim in enumerate(sub):
                p0, p1, p2 = tri_p[prim]
                tri_soa[base + s, 0:3] = p0
                tri_soa[base + s, 3:6] = p1 - p0
                tri_soa[base + s, 6:9] = p2 - p0
                tri_id[base + s] = prim

    return WideBVH(top_boxes, child_boxes, tri_soa, tri_id, b1, b2, k)
