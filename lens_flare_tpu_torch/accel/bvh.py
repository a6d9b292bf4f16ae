"""Host-side binary BVH construction, flattened to arrays for kernel G.

Counterpart of ``lens_flare_tpu/accel/bvh.py`` (a copy: the same boxes and
method give the same arrays).  Behavioral spec from the reference (``src/scene/bvh.cpp:54-177``): binary
tree, leaves hold <= ``max_leaf_size`` primitives, interior split = mean
centroid along the axis with the most balanced left/right counts, midpoint
fallback for degenerate splits.  The tree *shape* is not part of the contract
(closest-hit correctness is), so a binned-SAH builder is also provided and is
the default for performance; set ``method="mean"`` for the reference
heuristic.

The flattened layout is traversal-friendly:

- ``node_min/node_max``  (M, 3) child AABBs
- ``node_left/node_right`` (M,) child node indices (-1 for leaves)
- ``node_start/node_count`` (M,) leaf primitive ranges into ``prim_order``
- ``prim_order`` (N,) permutation of primitive ids, leaves contiguous

Nodes are emitted in depth-first order with the left child at
``parent + 1``, which makes near-child-first traversal cheap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    node_min: np.ndarray  # (M, 3) float32
    node_max: np.ndarray  # (M, 3)
    node_left: np.ndarray  # (M,) int32, -1 if leaf
    node_right: np.ndarray  # (M,) int32
    node_start: np.ndarray  # (M,) int32 index into prim_order
    node_count: np.ndarray  # (M,) int32, >0 iff leaf
    prim_order: np.ndarray  # (N,) int32
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.node_min)


def build_bvh(
    box_min: np.ndarray,
    box_max: np.ndarray,
    max_leaf_size: int = 4,
    method: str = "sah",
) -> FlatBVH:
    """Build a BVH over primitives given per-primitive AABBs.

    box_min/box_max: (N, 3).  Returns a FlatBVH.
    """
    n = len(box_min)
    if n == 0:
        return FlatBVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            node_left=np.array([-1], np.int32),
            node_right=np.array([-1], np.int32),
            node_start=np.array([0], np.int32),
            node_count=np.array([0], np.int32),
            prim_order=np.zeros(0, np.int32),
            max_depth=1,
        )

    if method == "sah":
        # the native C++ builder where g++ builds it (same layout, much faster)
        from .native import build_bvh_native

        native = build_bvh_native(box_min, box_max, max_leaf_size)
        if native is not None:
            return native

    box_min = np.asarray(box_min, np.float64)
    box_max = np.asarray(box_max, np.float64)
    centroids = (box_min + box_max) * 0.5
    order = np.arange(n)

    # Emit nodes in DFS order: parent, left subtree, right subtree.
    node_min, node_max = [], []
    node_left, node_right = [], []
    node_start, node_count = [], []

    splitter = _split_mean if method == "mean" else _split_sah

    max_depth = 0
    # stack of (index range into `order`, depth, parent_slot, is_left)
    stack = [(0, n, 1, -1, False)]
    while stack:
        lo, hi, depth, parent, is_left = stack.pop()
        idx = order[lo:hi]
        nm = box_min[idx].min(axis=0)
        nx = box_max[idx].max(axis=0)
        slot = len(node_min)
        node_min.append(nm)
        node_max.append(nx)
        node_left.append(-1)
        node_right.append(-1)
        node_start.append(lo)
        node_count.append(0)
        max_depth = max(max_depth, depth)
        if parent >= 0:
            if is_left:
                node_left[parent] = slot
            else:
                node_right[parent] = slot

        count = hi - lo
        if count <= max_leaf_size:
            node_count[slot] = count
            continue

        mid = splitter(centroids, box_min, box_max, order, lo, hi)
        # Depth-first: push right first so left is processed (and numbered) first.
        stack.append((mid, hi, depth + 1, slot, False))
        stack.append((lo, mid, depth + 1, slot, True))

    return FlatBVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_start=np.asarray(node_start, np.int32),
        node_count=np.asarray(node_count, np.int32),
        prim_order=order.astype(np.int32),
        max_depth=max_depth,
    )


def _split_mean(centroids, box_min, box_max, order, lo, hi) -> int:
    """Reference heuristic (bvh.cpp:99-158): mean centroid, most-balanced axis."""
    idx = order[lo:hi]
    cent = centroids[idx]
    means = cent.mean(axis=0)
    less = cent < means  # (count, 3)
    left_counts = less.sum(axis=0)
    count = hi - lo
    balance = np.abs(2 * left_counts - count)
    axis = int(np.argmin(balance))
    mask = less[:, axis]
    if mask.all() or not mask.any():
        mid = lo + count // 2
        # stable mid split on raw order (bvh.cpp:155-158)
        return mid
    # stable partition: keep relative order on both sides
    order[lo:hi] = np.concatenate([idx[mask], idx[~mask]])
    return lo + int(mask.sum())


def _split_sah(centroids, box_min, box_max, order, lo, hi, n_bins: int = 16) -> int:
    """Binned surface-area-heuristic split; falls back to median on degenerate."""
    idx = order[lo:hi]
    cent = centroids[idx]
    count = hi - lo

    c_lo = cent.min(axis=0)
    c_hi = cent.max(axis=0)
    extent = c_hi - c_lo

    best_cost = np.inf
    best_axis = -1
    best_bin = -1
    for axis in range(3):
        if extent[axis] <= 1e-12:
            continue
        scale = n_bins / extent[axis]
        bins = np.minimum(((cent[:, axis] - c_lo[axis]) * scale).astype(np.int64), n_bins - 1)
        # per-bin bbox + counts
        bin_counts = np.bincount(bins, minlength=n_bins)
        bmin = np.full((n_bins, 3), np.inf)
        bmax = np.full((n_bins, 3), -np.inf)
        for d in range(3):
            np.minimum.at(bmin[:, d], bins, box_min[idx][:, d])
            np.maximum.at(bmax[:, d], bins, box_max[idx][:, d])
        # prefix/suffix sweeps
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcnt = np.cumsum(bin_counts)
        rcnt = np.cumsum(bin_counts[::-1])[::-1]

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        costs = area(lmin, lmax)[:-1] * lcnt[:-1] + area(rmin[1:], rmax[1:]) * rcnt[1:]
        costs = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, costs)
        k = int(np.argmin(costs))
        if costs[k] < best_cost:
            best_cost = costs[k]
            best_axis = axis
            best_bin = k

    if best_axis < 0:
        return lo + count // 2

    scale = n_bins / extent[best_axis]
    bins = np.minimum(
        ((cent[:, best_axis] - c_lo[best_axis]) * scale).astype(np.int64), n_bins - 1
    )
    mask = bins <= best_bin
    if mask.all() or not mask.any():
        return lo + count // 2
    order[lo:hi] = np.concatenate([idx[mask], idx[~mask]])
    return lo + int(mask.sum())
