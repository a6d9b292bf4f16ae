"""Paraxial ghost tracing: 2x2 ray-transfer matrix chains.

Counterpart of ``lens_flare_tpu/lens/paraxial.py`` (``trace_ray_auto_before``
/ ``trace_ray_auto_after``, ``pathtracer.cpp:588-689``).  The JAX package
vmaps one masked trace over (pair, wavelength); here the pairs, wavelengths
and the two marginal rays are batch dimensions of one masked loop over the
interfaces.  Matrix conventions (``pathtracer.cpp:511-537``):

  T(d)       = [[1, d], [0, 1]]                translation by gap d
  R(c,n1,n2) = [[1, 0], [c(n1-n2)/n2, n1/n2]]  refraction at curvature c
  L(c)       = [[1, 0], [2c, 1]]               reflection at curvature c

:func:`physical_ghost_matrix` is the physically consistent first-order
chain, the paraxial limit of ``lens/realistic.py``'s stack.
"""

from __future__ import annotations

import torch

from .prescription import LensPrescription


def _m(a00, a01, a10, a11):
    """Stack four (...) tensors into (..., 2, 2)."""
    return torch.stack([torch.stack([a00, a01], -1), torch.stack([a10, a11], -1)], -2)


def _mm(a, b):
    """2x2 products of (..., 2, 2) stacks, written out."""
    return _m(
        a[..., 0, 0] * b[..., 0, 0] + a[..., 0, 1] * b[..., 1, 0],
        a[..., 0, 0] * b[..., 0, 1] + a[..., 0, 1] * b[..., 1, 1],
        a[..., 1, 0] * b[..., 0, 0] + a[..., 1, 1] * b[..., 1, 0],
        a[..., 1, 0] * b[..., 0, 1] + a[..., 1, 1] * b[..., 1, 1],
    )


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = _m(m[..., 1, 1], -m[..., 0, 1], -m[..., 1, 0], m[..., 0, 0])
    return inv / det[..., None, None]


def build_matrices(lens: LensPrescription):
    """Per-interface T (N,2,2), R (3,N,2,2) per wavelength, L (N,2,2)."""
    n = lens.num_interfaces
    zeros = torch.zeros_like(lens.spacings)
    ones = torch.ones_like(lens.spacings)
    T = _m(ones, lens.spacings, zeros, ones)
    c = lens.curvatures[:n]
    n_prev = torch.cat([torch.ones_like(lens.iors[:, :1]), lens.iors[:, : n - 1]], dim=1)
    n_next = lens.iors
    R = _m(
        torch.ones_like(n_next), torch.zeros_like(n_next),
        c * (n_prev - n_next) / n_next, n_prev / n_next,
    )
    L = _m(ones, zeros, 2.0 * c, ones)
    return T, R, L


def reference_ghost_pairs():
    """The 13 reflection pairs the reference enumerates (pathtracer.cpp:735-762)."""
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    pairs += [(i, j) for i in range(6, 9) for j in range(i + 1, 9)]
    return pairs


def trace_ghost(lens: LensPrescription, T, R, L, i, j, r_in, theta):
    """Sensor heights for reflection pairs (i, j) (P,), every wavelength and ray.

    R: (3, N, 2, 2); r_in: (S,) ray heights; theta: scalar angle.
    Returns (P, 3, S) sensor heights.
    """
    n = lens.num_interfaces
    ap = lens.aperture_index
    h = lens.aperture_height
    p = i.shape[0]
    s = r_in.shape[0]
    eye = torch.eye(2, dtype=T.dtype, device=T.device)
    M = eye.expand(p, 3, 2, 2)
    ray = torch.stack([r_in, theta.expand(s)], dim=-1).expand(p, 3, s, 2)  # (P, 3, S, 2)
    r_a = torch.where(r_in < 0, -(h - 0.1), h)  # reference quirk (pathtracer.cpp:623-625)

    def fwd_step(k, M, ray, active):
        a = active[:, None, None, None]
        if k == ap:
            a_x = M[..., 0, 0, None] * ray[..., 0] + M[..., 0, 1, None] * ray[..., 1]
            over = torch.abs(a_x) > h
            r_e = (r_a - M[..., 0, 1, None] * ray[..., 1]) / M[..., 0, 0, None]
            new_ray = torch.stack([r_e, ray[..., 1]], dim=-1)
            ray = torch.where(a & over[..., None], new_ray, ray)
            M_new = _mm(T[k], M)  # crossing the iris: translation only
        else:
            M_new = _mm(T[k], _mm(R[:, k], M))
        return torch.where(a, M_new, M), ray

    for k in range(n):  # forward through interfaces k < j
        M, ray = fwd_step(k, M, ray, k < j)
    M = _mm(L[j][:, None], M)  # reflect off surface j
    for k in range(n - 1, 0, -1):  # backward k = j-1 .. i+1
        active = ((k < j) & (k > i))[:, None, None, None]
        M = torch.where(active, _mm(_inv2(R[:, k]), _mm(T[k], M)), M)
    Ti = T[i][:, None]
    M = _mm(Ti, _mm(_inv2(L[i])[:, None], _mm(Ti, M)))  # reflect off surface i
    for k in range(n):  # forward k > i to the sensor
        M, ray = fwd_step(k, M, ray, k > i)
    return M[..., 0, 0, None] * ray[..., 0] + M[..., 0, 1, None] * ray[..., 1]


def physical_ghost_matrix(lens: LensPrescription, i: int, j: int, color: int):
    """First-order (2, 2) matrix of ghost pair (i, j): the paraxial limit of the realistic stack.

    Counterpart of ``paraxial.py:141-206``, under mirror unfolding:
    forward crossings ``T(d_k) @ R(c_k, n1, n2)``, the first reflection
    ``L(c_j)``, backward crossings ``R(-c_k, n2, n1) @ T(d_k)`` (media
    swapped and the curvature's sign flipped), the second reflection
    ``L(-c_i)``, forward to the sensor; the iris only translates.  The
    jacobian of :func:`..realistic.trace_ghost_stack` at (h, theta) =
    (0, 0) equals it for all 13 pairs x 3 wavelengths.  :func:`trace_ghost`
    keeps the reference's inv(R) backward crossings, which differ from
    this wherever the backward segment crosses a curved surface.
    ``[r_out, theta_out] = M @ [r_in, theta_in]``, the ray taken just
    before interface 0.
    """
    n = lens.num_interfaces
    ap = lens.aperture_index
    c, s, iors = lens.curvatures, lens.spacings, lens.iors[color]
    one, zero = torch.ones_like(s[0]), torch.zeros_like(s[0])
    eye = torch.eye(2, dtype=s.dtype, device=s.device)

    def Tm(d):
        return _m(one, d, zero, one)

    def Rm(c, n1, n2):
        return _m(one, zero, c * (n1 - n2) / n2, n1 / n2)

    def Lm(c):
        return _m(one, zero, 2.0 * c, one)

    def media(k):
        return (one if k == 0 else iors[k - 1]), iors[k]

    M = eye
    for k in range(j):
        Rk = eye if k == ap else Rm(c[k], *media(k))
        M = Tm(s[k]) @ Rk @ M
    M = Lm(c[j]) @ M
    for k in range(j - 1, i, -1):
        n1, n2 = media(k)
        Rk = eye if k == ap else Rm(-c[k], n2, n1)
        M = Rk @ Tm(s[k]) @ M
    M = Tm(s[i]) @ Lm(-c[i]) @ Tm(s[i]) @ M
    for k in range(i + 1, n):
        Rk = eye if k == ap else Rm(c[k], *media(k))
        M = Tm(s[k]) @ Rk @ M
    return M


def ghost_pair_table(device=None) -> torch.Tensor:
    """``reference_ghost_pairs()`` as a (13, 2) int64 tensor: made once, outside a captured program."""
    return torch.tensor(reference_ghost_pairs(), device=device)


def trace_all_ghosts(lens: LensPrescription, theta, pairs=None):
    """Sensor footprints (r1, r2), each (n_pairs, 3), of the +/- marginal rays.

    ``pairs``: :func:`ghost_pair_table` on the lens's device (made here when None).
    """
    T, R, L = build_matrices(lens)
    dev = T.device
    if pairs is None:
        pairs = ghost_pair_table(dev)
    theta = torch.as_tensor(theta, dtype=T.dtype, device=dev)
    r_in = torch.stack([lens.marginal_r, -lens.marginal_r])
    out = trace_ghost(lens, T, R, L, pairs[:, 0], pairs[:, 1], r_in, theta)
    return out[..., 0], out[..., 1]
