"""Ray / scene intersection through the hand-written CUDA kernels.

Counterpart of ``lens_flare_tpu/ops/intersect_pallas.py``.  The scene is the
same two-level cluster tree (``accel/wide.py:WideBVH``), kept in the layout a
thread wants to read: per-triangle rows ``tri`` (B1*B2*K, 12) =
[p0 | e1 | e2 | pad], child boxes (B1*B2, 8), top boxes (B1, 8), for
shade scenes slot-ordered shading rows (B1*B2*K, 10) and, for mxu scenes,
slot-major Möller-Trumbore coefficients (B1*B2*K, 4, 16) with the top
centres (B1, 3).  The TPU layouts of ``PallasScene`` (component-major
planes, 128-padded boxes, HBM pages, (16, B_nodes*128) coefficient lanes)
were VMEM workarounds and are not carried over.

Six kernels (``csrc/intersect.cu``), each with a plain PyTorch version
beside it that computes the same function with the same arithmetic:

==  =====================  ===========================================  ==========================
id  kernel                 replaces (intersect_pallas.py)               plain version
==  =====================  ===========================================  ==========================
A   lf_tree_closest        _make_kernel(any_hit=False) :214, :1392      :func:`tree_plain`
B   lf_tree_any_hit        _make_kernel(any_hit=True)  :214, :1392      :func:`tree_plain`
C   lf_brute               _make_brute_kernel :877, :1292               :func:`brute_plain`
D   lf_tree_closest_shade  _make_kernel(shade=True)    :214, :1392      ``tree_plain(shade=True)``
E   lf_tree_closest_mxu    _make_kernel(mxu=True)      :214, :559       ``tree_plain(mxu=True)``
F   lf_tree_group          _make_kernel(top_batch>1)   :214, :699       ``tree_plain(top_batch=tb)``
==  =====================  ===========================================  ==========================

E (the coefficient walk) and F (the top-batched group walk, closest hit,
any hit and shade) are reached only when a caller asks for them
(``intersect(mxu=True)``, ``intersect(top_batch=tb)``), as in the JAX
package, whose defaults are ``mxu=False`` and ``TOP_BATCH = 1``: the kernel
bench (:mod:`lens_flare_tpu_torch.bench_kernels`) is their path.

B and D walk one ray per warp (32 boxes or one chunk's slots at a time,
read coalesced); A, C, E and F one ray per thread.  All six give their
plain version's outputs bit for bit, ``tests`` included.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Each launch adds one to that
kernel's count in :data:`KERNELS`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

KINF = 3.0e38  # the kernels' "no hit yet" distance (intersect_pallas.INF)
# scenes of at most this many real triangles trace shadow rays with the
# tree-free kernel C (intersect_pallas.py:102)
BRUTE_MAX_TRIS = 512
BRUTE_TILE = 1024  # lanes per liveness group of kernel C (_auto_tile, brute)
BRUTE_BLOCK = 64  # rows per tie-breaking block of kernel C's closest hit
# lanes per tile of the group walk (F): the tile the TPU kernel saw, from
# _auto_tile on multi-level VMEM trees (intersect_pallas.py:67-83); the tile
# fixes the active-top list and, for any hit, when the walk stops.  Kernel F
# takes it as an argument, one block per tile (:func:`group_tile`).
GROUP_TILE = 512
GROUP_TILE_ANY_HIT = 1024
MXU_FEATURES = 10  # [1 | o-c | d | d x (o-c)]; the table pads to 16
# The JAX package's routing thresholds (intersect_pallas.py:87, :105).  They
# sized the TPU's VMEM; here they only decide, as there, which scenes take
# the shade kernel D: the port keeps the tree in global memory either way,
# and neither number is a memory limit of the card.
STREAM_THRESHOLD_BYTES = 10 * 2**20
SHADE_THRESHOLD_BYTES = 12 * 2**20


@dataclass
class KernelInfo:
    name: str
    symbol: str
    replaces: str
    launches: int = 0


KERNELS = {
    "A": KernelInfo(
        "tree_closest_hit", "lf_tree_closest",
        "lens_flare_tpu/ops/intersect_pallas.py:214",
    ),
    "B": KernelInfo(
        "tree_any_hit", "lf_tree_any_hit",
        "lens_flare_tpu/ops/intersect_pallas.py:214",
    ),
    "C": KernelInfo(
        "brute_any_hit", "lf_brute",
        "lens_flare_tpu/ops/intersect_pallas.py:877",
    ),
    "D": KernelInfo(
        "tree_closest_hit_shade", "lf_tree_closest_shade",
        "lens_flare_tpu/ops/intersect_pallas.py:214",
    ),
    "E": KernelInfo(
        "tree_closest_hit_mxu", "lf_tree_closest_mxu",
        "lens_flare_tpu/ops/intersect_pallas.py:214",
    ),
    "F": KernelInfo(
        "tree_group_walk", "lf_tree_group",
        "lens_flare_tpu/ops/intersect_pallas.py:214",
    ),
}
KERNEL_SOURCE = "lens_flare_tpu_torch/ops/csrc/intersect.cu"


def group_tile(any_hit: bool) -> int:
    """Lanes per tile of the group walk: kernel F's block and its plain version's tile."""
    return GROUP_TILE_ANY_HIT if any_hit else GROUP_TILE


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


@dataclass
class CudaScene:
    """Device-side cluster tree, built from a ``WideBVH`` (``accel/wide.py:31-38``)."""

    top: torch.Tensor  # (B1, 8) f32
    child: torch.Tensor  # (B1*B2, 8) f32
    tri: torch.Tensor  # (B1*B2*K, 12) f32 [p0 | e1 | e2 | pad]
    sph: torch.Tensor  # (max(S, 1), 8) f32 [center | radius | pad]
    slot_map: torch.Tensor  # (B1*B2*K + max(S, 1),) slot -> primitive id
    tri_brute: torch.Tensor  # (S_pad, 9) real triangle rows (brute mode)
    brute_map: torch.Tensor  # (S_pad + max(S, 1),)
    slot_shade: torch.Tensor  # (B1*B2*K, 10) shading row per slot (shade), else (1, 10)
    mxu_coef: torch.Tensor  # (B1*B2*K, 4, 16) [det | t.det | b1.det | b2.det] x features (mxu), else (1, 4, 16)
    mxu_centers: torch.Tensor  # (B1, 3) per-top centre the features are taken about (mxu), else (1, 3)
    b1: int
    b2: int
    k: int
    num_tris: int
    n_spheres: int
    brute: bool
    s_pad: int
    s_real: int
    stream: bool = False  # the JAX package's HBM-streaming choice (routing only)
    shade: bool = False  # closest hits take kernel D
    mxu: bool = False  # packed for the coefficient walk, kernel E

    @classmethod
    def from_wide_bvh(
        cls, wb, sph_center, sph_radius, num_tris: int, device,
        shade_rows=None, force_stream=None, stream_shade=False, mxu=False,
    ):
        """Pack a WideBVH; every mode choice and map follows ``PallasScene``.

        ``shade_rows``: the (num_tris, 10) [corner normals | bsdf id] table;
        with it, closest hits on mid-size multi-level scenes go through
        kernel D by ``PallasScene``'s predicate (``intersect_pallas.py:1112-1130``).
        ``force_stream`` and ``stream_shade`` only steer that routing.
        ``mxu``: also pack the coefficient table of kernel E (VMEM-mode,
        non-brute scenes with K = 32, as ``PallasScene(mxu=True)``).
        """
        dev = torch.device(device)
        n_sph = len(sph_center)
        b1, b2, k = int(wb.b1), int(wb.b2), int(wb.k)
        n_nodes = b1 * b2
        planes_bytes = 9 * k * n_nodes * 4
        stream = planes_bytes > STREAM_THRESHOLD_BYTES and b1 > 1
        if force_stream is not None:
            stream = bool(force_stream) and b1 > 1
        brute = (not stream) and 0 < num_tris <= BRUTE_MAX_TRIS
        sph_ids = (num_tris + np.arange(max(n_sph, 1))).astype(np.int32)
        if brute:
            real = wb.tri_id >= 0
            rows = np.ascontiguousarray(wb.tri_soa[real][:, :9], np.float32)
            s_real = rows.shape[0]
            s_pad = (max(s_real, 1) + 7) // 8 * 8
            rows = np.pad(rows, ((0, s_pad - s_real), (0, 0)))
            brute_map = np.concatenate(
                [np.pad(wb.tri_id[real].astype(np.int32), (0, s_pad - s_real)), sph_ids]
            )
        else:
            rows = np.zeros((8, 9), np.float32)
            brute_map = np.zeros(9, np.int32)
            s_pad = s_real = 0
        sph = np.zeros((max(n_sph, 1), 8), np.float32)
        if n_sph:
            sph[:n_sph, 0:3] = sph_center
            sph[:n_sph, 3] = sph_radius
        slot_map = np.concatenate([wb.tri_id.astype(np.int32), sph_ids])
        # the JAX package's routing rule, not a limit of this card: single-
        # level and tiny scenes keep kernel A (or C) plus the row gather
        shade = bool(
            shade_rows is not None
            and b1 > 1
            and num_tris > BRUTE_MAX_TRIS
            and (
                (stream and stream_shade)
                or (not stream and planes_bytes + 10 * k * n_nodes * 4 <= SHADE_THRESHOLD_BYTES)
            )
        )
        slot_shade = np.zeros((n_nodes * k if shade else 1, 10), np.float32)
        if shade:
            real = wb.tri_id >= 0  # padding slots keep zero rows
            slot_shade[real] = np.asarray(shade_rows, np.float32)[wb.tri_id[real]]
        mxu = bool(mxu) and not stream and not brute
        if mxu:
            if k != 32:
                raise ValueError(f"the coefficient walk assumes K = 32, got {k}")
            mxu_centers, mxu_coef = mxu_tables(wb)
        else:
            mxu_centers = np.zeros((1, 3), np.float32)
            mxu_coef = np.zeros((1, 4, 16), np.float32)

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=dev)

        return cls(
            top=t(wb.top_boxes),
            child=t(wb.child_boxes),
            tri=t(wb.tri_soa),
            sph=t(sph),
            slot_map=t(slot_map, np.int32),
            tri_brute=t(rows),
            brute_map=t(brute_map, np.int32),
            slot_shade=t(slot_shade),
            mxu_coef=t(mxu_coef),
            mxu_centers=t(mxu_centers),
            b1=b1,
            b2=b2,
            k=k,
            num_tris=int(num_tris),
            n_spheres=n_sph,
            brute=brute,
            s_pad=int(s_pad),
            s_real=int(s_real),
            stream=bool(stream),
            shade=shade,
            mxu=mxu,
        )


def mxu_tables(wb):
    """(centres (B1, 3), coefficients (B1*B2*K, 4, 16)) of the coefficient walk.

    With the features f = [1 | o-c | d | g = d x (o-c)] of a ray about its
    top's centre c, every Möller-Trumbore quantity is linear per slot:
    det = d.(e2 x e1), t.det = (o-c).n - p0.n with n = e1 x e2,
    b1.det = -g.e2 - d.(e2 x p0) and b2.det = g.e1 - d.(p0 x e1), with p0
    re-centred on c.  Built in float64 exactly as ``PallasScene``
    (``intersect_pallas.py:1175-1210``), then cast; rows are slot-major, so
    one thread reads one slot's 256 bytes.
    """
    b1, b2, k = int(wb.b1), int(wb.b2), int(wb.k)
    n_nodes = b1 * b2
    soa = wb.tri_soa.reshape(n_nodes, k, 12)
    if b1 > 1:
        tb = np.asarray(wb.top_boxes, np.float64)
        centers = (tb[:, 0:3] + tb[:, 3:6]) / 2.0
    else:
        cbx = np.asarray(wb.child_boxes, np.float64)
        ok = cbx[:, 0] <= cbx[:, 3]
        centers = (
            (cbx[ok, 0:3].min(axis=0) + cbx[ok, 3:6].max(axis=0)) / 2.0 if ok.any() else np.zeros(3)
        )[None]
    p0 = soa[:, :, 0:3].astype(np.float64) - np.repeat(centers, b2, axis=0)[:, None, :]
    e1 = soa[:, :, 3:6].astype(np.float64)
    e2 = soa[:, :, 6:9].astype(np.float64)
    n_vec = np.cross(e1, e2)
    c = np.zeros((n_nodes, k, 4, 16), np.float64)
    c[:, :, 0, 4:7] = np.cross(e2, e1)  # det <- d
    c[:, :, 1, 0] = -np.einsum("nkc,nkc->nk", p0, n_vec)  # t.det constant
    c[:, :, 1, 1:4] = n_vec  # t.det <- o - c
    c[:, :, 2, 4:7] = -np.cross(e2, p0)  # b1.det <- d
    c[:, :, 2, 7:10] = -e2  # b1.det <- g
    c[:, :, 3, 4:7] = -np.cross(p0, e1)  # b2.det <- d
    c[:, :, 3, 7:10] = e1  # b2.det <- g
    return centers.astype(np.float32), c.reshape(n_nodes * k, 4, 16).astype(np.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the card's reference)
# ---------------------------------------------------------------------------


def _safe_inv(d):
    eps = 1e-12
    return 1.0 / torch.where(d >= 0, torch.clamp_min(d, eps), torch.clamp_max(d, -eps))


def _box_hits(boxes, o, inv, t_lo, t_hi):
    """Slab tests of rays (N,) against boxes (B, 8), or per-ray boxes (N, B, 8) -> (N, B) bool."""
    bx = boxes if boxes.dim() == 3 else boxes[None]
    t_min = t_max = None
    for a in range(3):
        t1 = (bx[..., a] - o[:, a, None]) * inv[:, a, None]
        t2 = (bx[..., 3 + a] - o[:, a, None]) * inv[:, a, None]
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        t_min = torch.clamp_min(lo, -KINF) if t_min is None else torch.maximum(t_min, lo)
        t_max = torch.clamp_max(hi, KINF) if t_max is None else torch.minimum(t_max, hi)
    t_lo = t_lo[:, None]
    t_hi = t_hi[:, None]
    return (t_min <= t_max) & (t_max >= t_lo) & (t_min <= t_hi) & (t_lo <= t_hi)


def _mt_terms(tri, o, d):
    """Möller-Trumbore numerators; tri (..., >=9) broadcast against rays (..., 3)."""
    p0 = [tri[..., j] for j in range(3)]
    e1 = [tri[..., 3 + j] for j in range(3)]
    e2 = [tri[..., 6 + j] for j in range(3)]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    sx, sy, sz = ox - p0[0], oy - p0[1], oz - p0[2]
    s1x = dy * e2[2] - dz * e2[1]
    s1y = dz * e2[0] - dx * e2[2]
    s1z = dx * e2[1] - dy * e2[0]
    s2x = sy * e1[2] - sz * e1[1]
    s2y = sz * e1[0] - sx * e1[2]
    s2z = sx * e1[1] - sy * e1[0]
    det = s1x * e1[0] + s1y * e1[1] + s1z * e1[2]
    tt_n = s2x * e2[0] + s2y * e2[1] + s2z * e2[2]
    bb1_n = s1x * sx + s1y * sy + s1z * sz
    bb2_n = s2x * dx + s2y * dy + s2z * dz
    return det, tt_n, bb1_n, bb2_n


def _occludes(det, tt_n, bb1_n, bb2_n, t_lo, t_hi):
    """Divide-free any-hit conditions (intersect_pallas.py:459-484)."""
    sgn = torch.where(det >= 0, 1.0, -1.0)
    adet = det * sgn
    tts = tt_n * sgn
    b1s = bb1_n * sgn
    b2s = bb2_n * sgn
    return (
        (adet > 0) & (tts >= t_lo * adet) & (tts <= t_hi * adet)
        & (b1s >= 0) & (b1s <= adet) & (b2s >= 0) & (b2s <= adet) & (b1s + b2s <= adet)
    )


def _closest_terms(det, tt_n, bb1_n, bb2_n, t_lo, limit):
    """Closest-hit conditions -> (valid, t, b1, b2) (intersect_pallas.py:486-503)."""
    inv_det = 1.0 / torch.where(det == 0, 1e-30, det)
    tt = tt_n * inv_det
    b1 = bb1_n * inv_det
    b2 = bb2_n * inv_det
    valid = (
        (det != 0) & (tt >= t_lo) & (tt <= limit)
        & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b2 <= 1) & (b1 + b2 <= 1)
    )
    return valid, tt, b1, b2


def _mxu_features(o, d, c):
    """Features [1 | o-c | d | g = d x (o-c)] (N, 10) of rays about a top centre c (3,).

    Each component of g is rounded as ``mxu_fmat`` writes it
    (``intersect_pallas.py:322-326``): two products, then their difference.
    """
    oc = o - c
    g = [
        d[:, 1] * oc[:, 2] - d[:, 2] * oc[:, 1],
        d[:, 2] * oc[:, 0] - d[:, 0] * oc[:, 2],
        d[:, 0] * oc[:, 1] - d[:, 1] * oc[:, 0],
    ]
    return torch.stack([torch.ones_like(oc[:, 0]), oc[:, 0], oc[:, 1], oc[:, 2],
                        d[:, 0], d[:, 1], d[:, 2], *g], dim=1)


def _mxu_terms(coef, f):
    """(det, t.det, b1.det, b2.det) (P, K) from slot coefficients (P, K, 4, 16) and features (P, 10).

    Each is a dot product over the ten features, summed in order 0 -> 9 from
    the first product, as kernel E sums them.
    """
    out = []
    for j in range(4):
        acc = coef[..., j, 0] * f[:, None, 0]
        for q in range(1, MXU_FEATURES):
            acc = acc + coef[..., j, q] * f[:, None, q]
        out.append(acc)
    return out


def _sphere_pass(cs: CudaScene, o, d, t_lo, t_hi, best_t, slot, tests, base_slot):
    """Brute quadratic per sphere, then +n_spheres tests (intersect_pallas.py:840)."""
    for s in range(cs.n_spheres):
        c = cs.sph[s]
        ocx, ocy, ocz = o[:, 0] - c[0], o[:, 1] - c[1], o[:, 2] - c[2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        a = dx * dx + dy * dy + dz * dz
        bq = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        cq = ocx * ocx + ocy * ocy + ocz * ocz - c[3] * c[3]
        disc = bq * bq - 4.0 * a * cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-bq - sq) / (2.0 * a)
        t2 = (-bq + sq) / (2.0 * a)
        limit = torch.minimum(t_hi, best_t)
        t1_ok = (t1 >= t_lo) & (t1 <= limit)
        t2_ok = (t2 >= t_lo) & (t2 <= limit)
        ts = torch.where(t1_ok, t1, t2)
        improved = (disc >= 0) & (t1_ok | t2_ok) & (ts < best_t)
        best_t = torch.where(improved, ts, best_t)
        slot = torch.where(improved, base_slot + s, slot)
    if cs.n_spheres:
        tests = tests + cs.n_spheres
    return best_t, slot, tests


def _init_outputs(n, device):
    return (
        torch.full((n,), KINF, dtype=torch.float32, device=device),
        torch.full((n,), -1, dtype=torch.int32, device=device),
        torch.zeros((n, 2), dtype=torch.float32, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _commit_closest(best_t, slot, bary, gl, batch, node, k, terms, t_lo, t_hi):
    """Closest-hit update from (lane gl, chunk node) pairs whose batch order is ``batch``.

    The chunk batches of one top (or group) resolved in one vectorized step:
    the minimum t over the pairs wins if it beats the running best, from the
    earliest batch that reaches it, with the max slot id and barycentrics
    among the slots tied there — what the sequential per-batch update with
    the running limit min(t_hi, best_t) computes.
    """
    n = best_t.shape[0]
    dev = best_t.device
    valid, tt, bb1, bb2 = _closest_terms(*terms, t_lo[gl, None], t_hi[gl, None])
    tm = torch.where(valid, tt, KINF)
    pair_min = tm.min(dim=1).values  # (P,)
    lane_min = torch.full((n,), KINF, device=dev).scatter_reduce(0, gl, pair_min, "amin")
    cand = pair_min == lane_min[gl]
    big = torch.iinfo(torch.int64).max
    key = torch.where(cand, batch, big)
    lane_batch = torch.full((n,), big, device=dev).scatter_reduce(0, gl, key, "amin")
    win = cand & (batch == lane_batch[gl])
    is_best = valid & (tt == lane_min[gl, None]) & win[:, None]
    ids = (node * k).to(torch.int32)[:, None] + torch.arange(k, dtype=torch.int32, device=dev)
    pid = torch.where(is_best, ids, -1).max(dim=1).values
    pb1 = torch.where(is_best, bb1, -KINF).max(dim=1).values
    pb2 = torch.where(is_best, bb2, -KINF).max(dim=1).values
    new_slot = torch.full((n,), -1, dtype=torch.int32, device=dev).scatter_reduce(0, gl, pid, "amax")
    new_b1 = torch.full((n,), -KINF, device=dev).scatter_reduce(0, gl, pb1, "amax")
    new_b2 = torch.full((n,), -KINF, device=dev).scatter_reduce(0, gl, pb2, "amax")
    improved = lane_min < best_t
    best_t = torch.where(improved, lane_min, best_t)
    slot = torch.where(improved, new_slot, slot)
    bary = torch.where(improved[:, None], torch.stack([new_b1, new_b2], dim=1), bary)
    return best_t, slot, bary


def _finish(cs: CudaScene, o, d, t_lo, t_hi, best_t, slot, bary, tests, occluded, any_hit, shade):
    """Any-hit marker, D's shading rows (taken before the spheres), then the sphere pass."""
    if any_hit:
        slot = torch.where(occluded, 0, slot)
    if shade:
        rows = torch.where(
            (slot >= 0)[:, None], cs.slot_shade[torch.clamp_min(slot, 0).long()], 0.0
        )
    best_t, slot, tests = _sphere_pass(cs, o, d, t_lo, t_hi, best_t, slot, tests, cs.b1 * cs.b2 * cs.k)
    if shade:
        return best_t, slot, bary, tests, rows
    return best_t, slot, bary, tests


def tree_plain(cs: CudaScene, o, d, t_lo, t_hi, any_hit: bool, shade: bool = False,
               mxu: bool = False, top_batch: int = 1):
    """Plain version of kernels A, B, D, E and F: returns (t, slot, bary (N, 2), tests).

    ``shade`` (kernel D, closest hit on a shade scene): chunk batch 1, and a
    fifth output, the (N, 10) shading row of the best triangle slot taken
    before the sphere pass (zeros where no triangle was hit).
    ``mxu`` (kernel E, closest hit on an mxu scene): chunk batch 1, and the
    Möller-Trumbore numerators come from the slot coefficients and the
    features about the top's centre.  ``top_batch`` > 1 (kernel F): the
    group walk of :func:`_group_plain`.

    Lanes walk the tops in ascending order.  Within one top the chunk mask
    is fixed by the clipped interval at the top's start (:func:`_commit_closest`).
    """
    if top_batch > 1:
        return _group_plain(cs, o, d, t_lo, t_hi, any_hit, shade, top_batch)
    n = o.shape[0]
    dev = o.device
    best_t, slot, bary, tests = _init_outputs(n, dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    b1, b2, k = cs.b1, cs.b2, cs.k
    cb = 2 if (b1 == 1 and not any_hit and not shade and not mxu) else 1  # _auto_chunk_batch
    inv = _safe_inv(d)
    child = cs.child.view(b1, b2, 8)
    tri = cs.tri.view(b1, b2, k, 12)
    coef = cs.mxu_coef.view(b1, b2, k, 4, 16) if mxu else None

    for tp in range(b1):
        t_clip = torch.where(occluded, 0.0, t_hi) if any_hit else torch.minimum(t_hi, best_t)
        if b1 > 1:
            lanes = _box_hits(cs.top[tp : tp + 1], o, inv, t_lo, t_clip)[:, 0].nonzero()[:, 0]
            if lanes.numel() == 0:
                continue
        else:
            lanes = torch.arange(n, device=dev)
        ch = _box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_clip[lanes])  # (L, B2)
        tests.index_add_(0, lanes, (k * ch.sum(dim=1)).to(torch.int32))
        if any_hit:
            ch = ch & ~occluded[lanes, None]
        pl_, pc = ch.nonzero(as_tuple=True)  # (lane, child) pairs, lane-major
        if pl_.numel() == 0:
            continue
        gl = lanes[pl_]
        if mxu:
            terms = _mxu_terms(coef[tp, pc], _mxu_features(o[gl], d[gl], cs.mxu_centers[tp]))
        else:
            terms = _mt_terms(tri[tp, pc], o[gl, None, :], d[gl, None, :])
        if any_hit:
            hit = _occludes(*terms, t_lo[gl, None], t_hi[gl, None]).any(dim=1)
            occluded[gl[hit]] = True
            continue
        batch = pc if cb == 1 else ((ch.cumsum(dim=1) - 1) // cb)[pl_, pc]
        best_t, slot, bary = _commit_closest(
            best_t, slot, bary, gl, batch, tp * b2 + pc, k, terms, t_lo, t_hi
        )
    return _finish(cs, o, d, t_lo, t_hi, best_t, slot, bary, tests, occluded, any_hit, shade)


def _group_plain(cs: CudaScene, o, d, t_lo, t_hi, any_hit: bool, shade: bool, tb: int):
    """Plain version of kernel F: the top-batched group walk (``intersect_pallas.py:699-816``).

    Rays go in tiles of :func:`group_tile` lanes, as the TPU kernel's grid
    saw them.  A tile's active tops are those any of its lanes hits under
    [t_lo, t_hi], tail padding lanes included (o = d = 0, t_lo = t_hi = 0,
    ``intersect_pallas.py:1435-1440``), in ascending order.  Each lane walks
    that list in groups of ``tb`` tops: the clip interval is fixed at the
    group's start (min(t_hi, best_t), or [t_lo, 0] once occluded), K tests
    are charged for each of the group's child boxes hit under it, and the
    group's chunks resolve in group order (tops in list order, children
    ascending).  Any hit: a tile stops before a group once every lane is
    occluded or dead (t_hi <= t_lo).
    """
    n = o.shape[0]
    dev = o.device
    b1, b2, k = cs.b1, cs.b2, cs.k
    tile = group_tile(any_hit)
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    pad_rows = torch.nn.functional.pad
    top_hits = _box_hits(
        cs.top, pad_rows(o, (0, 0, 0, pad)), _safe_inv(pad_rows(d, (0, 0, 0, pad))),
        pad_rows(t_lo, (0, pad)), pad_rows(t_hi, (0, pad)),
    )
    flags = top_hits.view(n_tiles, tile, b1).any(dim=1)  # (T, B1)
    # each tile's active tops in ascending order, then b1 as "none"
    tops = torch.where(flags, torch.arange(b1, device=dev), b1).sort(dim=1).values
    n_groups = (flags.sum(dim=1) + tb - 1) // tb
    lane_tile = torch.arange(n, device=dev) // tile

    best_t, slot, bary, tests = _init_outputs(n, dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    dead = t_hi <= t_lo
    inv = _safe_inv(d)
    child = cs.child.view(b1, b2, 8)
    tri = cs.tri.view(b1 * b2, k, 12)
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    for g in range(int(n_groups.max()) if n_tiles else 0):
        walking = walking & (g < n_groups)
        if any_hit:  # the while_loop's exit test, before each group
            done = pad_rows(occluded | dead, (0, pad), value=True).view(n_tiles, tile).all(dim=1)
            walking = walking & ~done
        if not bool(walking.any()):
            break
        t_clip = torch.where(occluded, 0.0, t_hi) if any_hit else torch.minimum(t_hi, best_t)
        parts = []
        for u in range(min(tb, b1 - g * tb)):
            tl = torch.where(walking, tops[:, g * tb + u], b1)[lane_tile]  # (n,) this lane's top
            lanes = (tl < b1).nonzero()[:, 0]
            tp = tl[lanes]
            # children lie inside their top's box, so a lane that misses the
            # top box under the clip misses every child: skip it
            keep = _box_hits(cs.top[tp][:, None, :], o[lanes], inv[lanes], t_lo[lanes], t_clip[lanes])[:, 0]
            lanes, tp = lanes[keep], tp[keep]
            if lanes.numel() == 0:
                continue
            ch = _box_hits(child[tp], o[lanes], inv[lanes], t_lo[lanes], t_clip[lanes])  # (L, B2)
            tests.index_add_(0, lanes, (k * ch.sum(dim=1)).to(torch.int32))
            if any_hit:
                ch = ch & ~occluded[lanes, None]
            pl_, pc = ch.nonzero(as_tuple=True)
            parts.append((lanes[pl_], tp[pl_] * b2 + pc, u * b2 + pc))
        if not parts:
            continue
        gl, node, batch = (torch.cat(x) for x in zip(*parts))
        if gl.numel() == 0:
            continue
        terms = _mt_terms(tri[node], o[gl, None, :], d[gl, None, :])
        if any_hit:
            hit = _occludes(*terms, t_lo[gl, None], t_hi[gl, None]).any(dim=1)
            occluded[gl[hit]] = True
        else:
            best_t, slot, bary = _commit_closest(best_t, slot, bary, gl, batch, node, k, terms, t_lo, t_hi)
    return _finish(cs, o, d, t_lo, t_hi, best_t, slot, bary, tests, occluded, any_hit, shade)


def brute_plain(cs: CudaScene, o, d, t_lo, t_hi, any_hit: bool = True):
    """Plain version of kernel C: returns (t, slot, bary (N, 2), tests)."""
    n = o.shape[0]
    dev = o.device
    best_t, slot, bary, tests = _init_outputs(n, dev)
    live = t_hi > t_lo
    n_tiles = -(-n // BRUTE_TILE)
    pad = n_tiles * BRUTE_TILE - n
    tile_live = torch.nn.functional.pad(live, (0, pad)).view(n_tiles, BRUTE_TILE).any(dim=1)
    tile_live = tile_live.repeat_interleave(BRUTE_TILE)[:n]
    rows = cs.tri_brute[: cs.s_real]  # padding rows never hit (det == 0)
    if any_hit:
        det, tt_n, bb1_n, bb2_n = _mt_terms(rows[None], o[:, None, :], d[:, None, :])
        occ = _occludes(det, tt_n, bb1_n, bb2_n, t_lo[:, None], t_hi[:, None]).any(dim=1)
        slot = torch.where(occ, 0, slot)
    else:
        for c0 in range(0, cs.s_real, BRUTE_BLOCK):
            blk = rows[c0 : c0 + BRUTE_BLOCK]
            det, tt_n, bb1_n, bb2_n = _mt_terms(blk[None], o[:, None, :], d[:, None, :])
            limit = torch.minimum(t_hi, best_t)[:, None]
            valid, tt, bb1, bb2 = _closest_terms(det, tt_n, bb1_n, bb2_n, t_lo[:, None], limit)
            tm = torch.where(valid, tt, KINF)
            t_k = tm.min(dim=1).values
            is_best = valid & (tm == t_k[:, None])
            ids = torch.arange(c0, c0 + blk.shape[0], dtype=torch.int32, device=dev)
            improved = t_k < best_t
            best_t = torch.where(improved, t_k, best_t)
            slot = torch.where(improved, torch.where(is_best, ids, -1).max(dim=1).values, slot)
            nb = torch.stack(
                [torch.where(is_best, bb1, -KINF).max(dim=1).values,
                 torch.where(is_best, bb2, -KINF).max(dim=1).values], dim=1,
            )
            bary = torch.where(improved[:, None], nb, bary)
    tests = torch.where(live, cs.s_real, 0).to(torch.int32)
    best_t, slot, tests = _sphere_pass(cs, o, d, t_lo, t_hi, best_t, slot, tests, cs.s_pad)
    # a tile with no live lane does nothing at all
    t0, s0, b0, n0 = _init_outputs(n, dev)
    return (
        torch.where(tile_live, best_t, t0),
        torch.where(tile_live, slot, s0),
        torch.where(tile_live[:, None], bary, b0),
        torch.where(tile_live, tests, n0),
    )


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------


def _check_rays(cs: CudaScene, o, d, t_lo, t_hi):
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t_lo", t_lo, (n,)), ("t_hi", t_hi, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if cs.tri.device != o.device:
        raise ValueError(f"scene is on {cs.tri.device}, rays on {o.device}")


def _check_warp_walk_tree(cs: CudaScene):
    """Kernels B and D read boxes and triangle rows as float4: the tree's own shapes, contiguous, 16-byte aligned."""
    if min(cs.b1, cs.b2, cs.k) < 1:
        raise ValueError(f"tree shape ({cs.b1}, {cs.b2}, {cs.k}) has an empty level")
    n_nodes = cs.b1 * cs.b2
    for name, x, shape in (("top", cs.top, (cs.b1, 8)), ("child", cs.child, (n_nodes, 8)),
                           ("tri", cs.tri, (n_nodes * cs.k, 12))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: want a contiguous, 16-byte aligned float32 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)} at offset {x.data_ptr() % 16}")


def _launch(key: str, cs: CudaScene, o, d, t_lo, t_hi, closest: bool, tb: int = 1, shade: bool = False):
    from ._build import load_library

    if key in ("B", "D"):
        _check_warp_walk_tree(cs)
    lib = load_library()
    n = o.shape[0]
    o, d, t_lo, t_hi = (x.contiguous() for x in (o, d, t_lo, t_hi))
    out_t, out_slot, out_bary, out_tests = (
        torch.empty((n,), dtype=torch.float32, device=o.device),
        torch.empty((n,), dtype=torch.int32, device=o.device),
        torch.empty((n, 2), dtype=torch.float32, device=o.device),
        torch.empty((n,), dtype=torch.int32, device=o.device),
    )
    shade = shade or key == "D"
    out_rows = torch.empty((n, 10), dtype=torch.float32, device=o.device) if shade else None
    rays = [o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr()]
    outs = [out_t.data_ptr(), out_slot.data_ptr(), out_bary.data_ptr(), out_tests.data_ptr()]
    tree = [cs.top.data_ptr(), cs.child.data_ptr()]
    shape = [n, cs.b1, cs.b2, cs.k, cs.n_spheres]
    stream = torch.cuda.current_stream(o.device).cuda_stream
    if key == "C":
        rc = lib.lf_brute(
            *rays, cs.tri_brute.data_ptr(), cs.sph.data_ptr(),
            n, cs.s_real, cs.s_pad, cs.n_spheres, int(closest), *outs, stream,
        )
    elif key == "A":
        cb = 2 if cs.b1 == 1 else 1  # _auto_chunk_batch
        rc = lib.lf_tree_closest(*rays, *tree, cs.tri.data_ptr(), cs.sph.data_ptr(), *shape, cb, *outs, stream)
    elif key == "D":
        rc = lib.lf_tree_closest_shade(
            *rays, *tree, cs.tri.data_ptr(), cs.slot_shade.data_ptr(), cs.sph.data_ptr(),
            *shape, *outs, out_rows.data_ptr(), stream,
        )
    elif key == "E":
        rc = lib.lf_tree_closest_mxu(
            *rays, *tree, cs.mxu_coef.data_ptr(), cs.mxu_centers.data_ptr(), cs.sph.data_ptr(),
            *shape, *outs, stream,
        )
    elif key == "F":
        rc = lib.lf_tree_group(
            *rays, *tree, cs.tri.data_ptr(), cs.slot_shade.data_ptr(), cs.sph.data_ptr(),
            *shape, tb, group_tile(not closest), int(not closest), int(shade), *outs,
            out_rows.data_ptr() if shade else None, stream,
        )
    else:
        rc = lib.lf_tree_any_hit(*rays, *tree, cs.tri.data_ptr(), cs.sph.data_ptr(), *shape, *outs, stream)
    if rc != 0:
        raise RuntimeError(f"kernel {KERNELS[key].symbol} failed to launch: cudaError {rc}")
    KERNELS[key].launches += 1
    if shade:
        return out_t, out_slot, out_bary, out_tests, out_rows
    return out_t, out_slot, out_bary, out_tests


def _dispatch(key: str, plain, cs: CudaScene, o, d, t_lo, t_hi, closest: bool, **kw):
    _check_rays(cs, o, d, t_lo, t_hi)
    if o.device.type == "cpu":
        return plain()
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    return _launch(key, cs, o, d, t_lo, t_hi, closest, **kw)


def tree_closest_hit(cs: CudaScene, o, d, t_lo, t_hi):
    """Kernel A (CUDA tensors) or its plain version (CPU tensors)."""
    return _dispatch("A", lambda: tree_plain(cs, o, d, t_lo, t_hi, False), cs, o, d, t_lo, t_hi, True)


def tree_closest_shade(cs: CudaScene, o, d, t_lo, t_hi):
    """Kernel D (CUDA tensors) or its plain version (CPU tensors).

    Returns (t, slot, bary, tests, rows (N, 10)).
    """
    if not cs.shade:
        raise ValueError("scene was not packed with shading rows for kernel D")
    return _dispatch(
        "D", lambda: tree_plain(cs, o, d, t_lo, t_hi, False, shade=True), cs, o, d, t_lo, t_hi, True
    )


def tree_closest_mxu(cs: CudaScene, o, d, t_lo, t_hi):
    """Kernel E, the coefficient walk (CUDA tensors), or its plain version (CPU tensors)."""
    if not cs.mxu:
        raise ValueError("scene was not packed with mxu=True for kernel E")
    return _dispatch(
        "E", lambda: tree_plain(cs, o, d, t_lo, t_hi, False, mxu=True), cs, o, d, t_lo, t_hi, True
    )


def tree_group(cs: CudaScene, o, d, t_lo, t_hi, top_batch: int, any_hit: bool = False, shade: bool = False):
    """Kernel F, the group walk of ``top_batch`` tops (CUDA tensors), or its plain version (CPU tensors).

    Multi-level, non-stream scenes only, with 2 <= top_batch <= B1.
    ``shade`` (closest hit on a shade scene) appends D's (N, 10) rows.
    """
    if not (cs.b1 > 1 and not cs.stream and 2 <= top_batch <= cs.b1):
        raise ValueError(f"the group walk needs a multi-level VMEM-mode tree and 2 <= top_batch <= B1, "
                         f"got B1={cs.b1}, stream={cs.stream}, top_batch={top_batch}")
    if shade and (any_hit or not cs.shade):
        raise ValueError("the shade group walk needs a shade scene and closest hit")
    return _dispatch(
        "F", lambda: tree_plain(cs, o, d, t_lo, t_hi, any_hit, shade=shade, top_batch=top_batch),
        cs, o, d, t_lo, t_hi, not any_hit, tb=top_batch, shade=shade,
    )


def tree_any_hit(cs: CudaScene, o, d, t_lo, t_hi):
    """Kernel B (CUDA tensors) or its plain version (CPU tensors)."""
    return _dispatch("B", lambda: tree_plain(cs, o, d, t_lo, t_hi, True), cs, o, d, t_lo, t_hi, False)


def brute_hit(cs: CudaScene, o, d, t_lo, t_hi, any_hit: bool = True):
    """Kernel C (CUDA tensors) or its plain version (CPU tensors)."""
    if not cs.brute:
        raise ValueError("scene was not packed for brute mode")
    return _dispatch(
        "C", lambda: brute_plain(cs, o, d, t_lo, t_hi, any_hit), cs, o, d, t_lo, t_hi, not any_hit
    )


def intersect(cs: CudaScene, o, d, t_lo, t_hi, any_hit: bool = False, brute=None,
              return_shade: bool = False, top_batch=None, mxu: bool = False):
    """Rays (N, 3) -> (t, prim, b1, b2, hit, tests), the ``intersect_pallas`` contract.

    ``brute=None`` takes kernel C for any-hit queries on brute-mode scenes
    (``intersect_pallas.py:1422-1425``); True/False force it either way.
    For any-hit queries ``prim`` is -1: only ``hit`` is meaningful.

    ``return_shade`` (requires ``cs.shade``, closest hit): trace with kernel
    D and append the winner's shading row, (N, 10) row-major [9 corner-normal
    components | bsdf id] — the transpose of the JAX package's (10, N)
    ``shade_cm``.  Where a sphere wins, the row is the best triangle's.

    ``mxu`` (requires ``cs.mxu``, plain closest hit): the coefficient walk,
    kernel E.  ``top_batch``: tops per group of the group walk, kernel F;
    None means 1 (the JAX package's ``TOP_BATCH``), and it clamps to 1 on
    single-level and stream scenes (``intersect_pallas.py:1316``) and under
    ``mxu``, where the call takes A, B or D.
    """
    brute = (cs.brute and any_hit) if brute is None else (bool(brute) and cs.brute)
    shade = bool(return_shade) and cs.shade and not any_hit and not brute
    if return_shade and not shade:
        raise ValueError("return_shade requires a shade scene and closest hit")
    if mxu and not (cs.mxu and not any_hit and not brute and not shade):
        raise ValueError("mxu requires a scene packed with mxu=True and plain closest hit")
    tb = 1 if (top_batch is None or mxu) else int(top_batch)
    tb = max(1, min(tb, cs.b1)) if (cs.b1 > 1 and not cs.stream) else 1
    if brute:
        t, slot, bary, tests = brute_hit(cs, o, d, t_lo, t_hi, any_hit=any_hit)
    elif tb > 1:
        out = tree_group(cs, o, d, t_lo, t_hi, tb, any_hit=any_hit, shade=shade)
        t, slot, bary, tests = out[:4]
        rows = out[4] if shade else None
    elif shade:
        t, slot, bary, tests, rows = tree_closest_shade(cs, o, d, t_lo, t_hi)
    elif any_hit:
        t, slot, bary, tests = tree_any_hit(cs, o, d, t_lo, t_hi)
    elif mxu:
        t, slot, bary, tests = tree_closest_mxu(cs, o, d, t_lo, t_hi)
    else:
        t, slot, bary, tests = tree_closest_hit(cs, o, d, t_lo, t_hi)
    hit = slot >= 0
    if any_hit:
        prim = torch.full_like(slot, -1)
    else:
        smap = cs.brute_map if brute else cs.slot_map
        prim = torch.where(hit, smap[torch.clamp_min(slot, 0).long()], -1)
    out = (t, prim, bary[:, 0], bary[:, 1], hit, tests)
    return out + (rows,) if shade else out
