"""Full sequential lens-stack ray tracing: Snell refraction + Fresnel ghosts.

Counterpart of ``lens_flare_tpu/lens/realistic.py`` (BASELINE config 3):
real 3-D rays are traced surface by surface through the prescription,
each interface doing exact Snell refraction with the exact unpolarized
dielectric Fresnel transmittance; a ghost is the two-reflection path
(i, j), whose energy is the product of Fresnel R at the two bounce
surfaces and T everywhere else (the paraxial model's flat "10/scale^2"
intensity is what this replaces).

Every function is plain tensor math, differentiable in the prescription,
and takes float32 or float64 tensors; its device is its tensors'.  The JAX
package runs ``render_ghosts_stack`` as one jitted program with a
``lax.scan`` over the event columns; here the scan is a Python loop over
the E = 17 columns of the reference lens's event table.

Geometry: optical axis +z, surface vertex i at z_i = sum(spacings[:i]),
sensor plane at z = sum(spacings).  A spherical surface with curvature c
has its centre at z_i + 1/c; |c| < 1e-9 is planar (the iris, and the flat
glass face at interface 6, which refracts).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .paraxial import reference_ghost_pairs
from .prescription import LensPrescription

# event kinds of the table-driven batched trace
_EV_T, _EV_R, _EV_AP, _EV_NOOP = 0, 1, 2, 3


def surface_z(lens: LensPrescription):
    """Axial vertex positions (N+1,): interfaces 0..N-1 then the sensor plane."""
    return torch.cat([torch.zeros_like(lens.spacings[:1]), torch.cumsum(lens.spacings, 0)])


def _dot(a, b):
    return (a * b).sum(-1)


def _safe_sqrt(x):
    """sqrt clamped at 0 with a NaN-free gradient.

    ``sqrt(max(x, 0))`` backpropagates ``inf * 0 = NaN`` for x <= 0 even
    where the lane is masked downstream; the inner ``where`` keeps the
    untaken branch finite.
    """
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def fresnel_dielectric(cos_i, n1, n2):
    """Exact unpolarized dielectric Fresnel reflectance; total internal reflection gives 1."""
    cos_i = torch.abs(cos_i)
    sin2_t = (n1 / n2) ** 2 * torch.clamp_min(1.0 - cos_i**2, 0.0)
    tir = sin2_t >= 1.0
    cos_t = _safe_sqrt(1.0 - sin2_t)
    rs = ((n1 * cos_i - n2 * cos_t) / torch.clamp_min(n1 * cos_i + n2 * cos_t, 1e-12)) ** 2
    rp = ((n1 * cos_t - n2 * cos_i) / torch.clamp_min(n1 * cos_t + n2 * cos_i, 1e-12)) ** 2
    return torch.where(tir, 1.0, 0.5 * (rs + rp))


def _intersect_surface(o, d, z_vertex, c):
    """Ray to spherical (or planar) interface -> (t, normal, valid).

    o, d: (..., 3); ``z_vertex`` and ``c`` broadcast against ``o[..., 0]``:
    0-d tensors in the unrolled trace, (G, 1) in the batched one.  The
    normal opposes the ray.
    """
    shape = o.shape[:-1]
    z_b = torch.broadcast_to(c * 0.0 + z_vertex, shape)
    planar = torch.broadcast_to(torch.abs(c) < 1e-9, shape)
    dz = d[..., 2]
    t_plane = (z_b - o[..., 2]) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    n_plane = torch.zeros_like(o)
    n_plane[..., 2].fill_(-1.0)  # a fill on the device: capturable

    # sphere: centre on the axis at z_vertex + R, R = 1/c
    R = 1.0 / torch.where(planar, 1.0, torch.broadcast_to(c, shape))
    zero = torch.zeros_like(z_b)
    center = torch.stack([zero, zero, z_b + R], dim=-1)
    oc = o - center
    b = 2.0 * _dot(oc, d)
    cc = _dot(oc, oc) - R * R
    disc = b * b - 4.0 * cc  # |d| = 1
    sq = _safe_sqrt(disc)
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    # the root nearest the vertex plane (the lens cap, not the sphere's far
    # side): travelling in +z, the near root for R > 0, the far one for R < 0
    near_first = torch.where(dz > 0, R > 0, R < 0)
    t_sph = torch.where(near_first, t1, t2)
    p = o + d * t_sph[..., None]
    n_sph = (p - center) / R[..., None]
    flip = _dot(n_sph, d) > 0
    n_sph = torch.where(flip[..., None], -n_sph, n_sph)

    t = torch.where(planar, t_plane, t_sph)
    n = torch.where(planar[..., None], n_plane, n_sph)
    n_flip = _dot(n, d) > 0
    n = torch.where(n_flip[..., None], -n, n)
    valid = torch.where(planar, torch.abs(dz) > 1e-12, disc >= 0) & (t > 1e-9)
    return t, n, valid


def _refract(d, n, eta_ratio):
    """Snell's law; ``n`` opposes ``d``. Returns (d_new, valid)."""
    cos_i = -_dot(d, n)
    sin2_t = eta_ratio**2 * torch.clamp_min(1.0 - cos_i**2, 0.0)
    tir = sin2_t > 1.0
    cos_t = _safe_sqrt(1.0 - sin2_t)
    d_new = eta_ratio[..., None] * d + (eta_ratio * cos_i - cos_t)[..., None] * n
    d_new = d_new / torch.clamp_min(torch.linalg.vector_norm(d_new, dim=-1, keepdim=True), 1e-12)
    return d_new, ~tir


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[..., None] * n


class StackTrace(NamedTuple):
    xy: torch.Tensor  # (..., 2) sensor-plane coordinates
    energy: torch.Tensor  # (...,) product of Fresnel factors (0 = vignetted)


def _to_sensor(zs, n_int, o, d, energy, valid):
    """Propagate to the sensor plane; lanes that would go backwards are vignetted."""
    dz = d[..., 2]
    t = (zs[n_int] - o[..., 2]) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    p = o + d * t[..., None]
    valid = valid & (t > 0)
    return StackTrace(xy=p[..., :2], energy=energy * valid.to(energy.dtype))


def trace_ghost_stack(lens: LensPrescription, o, d, color: int, pair):
    """Trace rays through reflection pair (i, j) to the sensor.

    o, d: (..., 3) in lens space; ``color`` in {0, 1, 2}; ``pair`` = (i, j)
    Python ints.  The surface events are static: 0..j forward, reflect at
    j, back to i, reflect at i, forward to the sensor.
    """
    i, j = pair
    n_int = lens.num_interfaces
    zs = surface_z(lens)
    iors = lens.iors[color]
    energy = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    valid = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)

    events = [("R" if k == j else "T", k, False) for k in range(j + 1)]
    events += [("R" if k == i else "T", k, True) for k in range(j - 1, i - 1, -1)]
    events += [("T", k, False) for k in range(i + 1, n_int)]
    for kind, k, backward in events:
        t, n, ok = _intersect_surface(o, d, zs[k], lens.curvatures[k])
        p = o + d * t[..., None]
        valid = valid & ok
        if k == lens.aperture_index:  # the iris clips and neither refracts nor reflects
            ok = p[..., 0] ** 2 + p[..., 1] ** 2 <= lens.aperture_height**2
            energy = energy * ok.to(energy.dtype)
            valid = valid & ok
            o = p
            continue
        n1, n2 = (1.0 if k == 0 else iors[k - 1]), iors[k]
        if backward:
            n1, n2 = n2, n1
        cos_i = -_dot(d, n)
        refl = fresnel_dielectric(cos_i, n1, n2)
        if kind == "T":
            d, ok_r = _refract(d, n, torch.broadcast_to(n1 / n2, cos_i.shape))
            energy = energy * (1.0 - refl)
            valid = valid & ok_r
        else:  # the ghost bounce
            d = _reflect(d, n)
            energy = energy * refl
        o = p
    return _to_sensor(zs, n_int, o, d, energy, valid)


def build_event_table(pairs, n_interfaces: int, aperture_index: int):
    """Static per-ghost surface-event tables, padded to a common length.

    Returns NumPy (surf, kind, bwd), each (G, E), for the G = len(pairs)
    ghosts: the event sequences :func:`trace_ghost_stack` unrolls, as data,
    so one step executes every ghost in lockstep.  Only a forward ``T`` at
    the iris becomes ``_EV_AP``; ``_EV_NOOP`` pads the shorter ghosts.
    """
    rows = []
    for i, j in pairs:
        ev = [(k, _EV_R if k == j else _EV_T, 0) for k in range(j + 1)]
        ev += [(k, _EV_R if k == i else _EV_T, 1) for k in range(j - 1, i - 1, -1)]
        ev += [(k, _EV_T, 0) for k in range(i + 1, n_interfaces)]
        rows.append([(k, _EV_AP if (k == aperture_index and kd == _EV_T) else kd, bw) for k, kd, bw in ev])
    n_ev = max(len(r) for r in rows)
    surf = np.zeros((len(rows), n_ev), np.int32)
    kind = np.full((len(rows), n_ev), _EV_NOOP, np.int32)
    bwd = np.zeros((len(rows), n_ev), np.int32)
    for g, ev in enumerate(rows):
        for e, (k, kd, bw) in enumerate(ev):
            surf[g, e], kind[g, e], bwd[g, e] = k, kd, bw
    return surf, kind, bwd


def trace_ghosts_batched(lens: LensPrescription, o, d, colors, surf, kind, bwd):
    """Table-driven batched ghost trace: a loop over event columns, every ghost in lockstep.

    o, d: (G, N, 3); ``colors``: (G,) integer wavelength per ghost;
    ``surf``/``kind``/``bwd``: (G, E) integer tables from
    :func:`build_event_table` (NumPy or tensors).  Returns a
    :class:`StackTrace` with xy (G, N, 2) and energy (G, N), the per-pair
    :func:`trace_ghost_stack`'s values.
    """
    dev = o.device
    zs = surface_z(lens)
    n_int = lens.num_interfaces
    surf, kind, bwd, colors = (torch.as_tensor(a, device=dev).long() for a in (surf, kind, bwd, colors))
    # ior_ext[c, k]: the medium before interface k (air for k = 0), so the
    # forward media across interface k are (ior_ext[k], ior_ext[k + 1])
    ior_ext = torch.cat([torch.ones_like(lens.iors[:, :1]), lens.iors], dim=1)
    iors_g = ior_ext[colors]  # (G, N_int + 1)
    energy = torch.ones(o.shape[:-1], dtype=o.dtype, device=dev)
    valid = torch.ones(o.shape[:-1], dtype=torch.bool, device=dev)
    h2 = lens.aperture_height**2

    for e in range(surf.shape[1]):
        k, kd, bw = surf[:, e, None], kind[:, e, None], bwd[:, e, None]  # (G, 1)
        t, n, ok = _intersect_surface(o, d, zs[k], lens.curvatures[k])
        p = o + d * t[..., None]
        is_refl, is_ap, is_noop = kd == _EV_R, kd == _EV_AP, kd == _EV_NOOP
        ap_ok = p[..., 0] ** 2 + p[..., 1] ** 2 <= h2

        n1 = torch.gather(iors_g, 1, k)  # (G, 1)
        n2 = torch.gather(iors_g, 1, k + 1)
        back = bw == 1
        n1, n2 = torch.where(back, n2, n1), torch.where(back, n1, n2)

        cos_i = -_dot(d, n)
        refl = fresnel_dielectric(cos_i, n1, n2)
        d_refr, ok_r = _refract(d, n, torch.broadcast_to(n1 / n2, cos_i.shape))
        d_refl = _reflect(d, n)

        new_d = torch.where((is_ap | is_noop)[..., None], d, torch.where(is_refl[..., None], d_refl, d_refr))
        gain = torch.where(is_refl, refl, torch.where(is_ap, ap_ok.to(refl.dtype), 1.0 - refl))
        energy = torch.where(is_noop, energy, energy * gain)
        ev_ok = ok & torch.where(is_ap, ap_ok, is_refl | ok_r)
        valid = valid & (is_noop | ev_ok)
        o = torch.where(is_noop[..., None], o, p)
        d = new_d
    return _to_sensor(zs, n_int, o, d, energy, valid)


class GhostStackTables(NamedTuple):
    """The static tables of :func:`render_ghosts_stack`, on its device."""

    gx: torch.Tensor  # (S*S,) float32 pupil grid, x
    gy: torch.Tensor  # (S*S,) float32 pupil grid, y
    disc: torch.Tensor  # (S*S,) float32: 1 inside the unit disc
    n_rays: int  # grid points inside the disc
    surf: torch.Tensor  # (G, E) int64 event tables, one row per (pair, wavelength)
    kind: torch.Tensor
    bwd: torch.Tensor
    colors: torch.Tensor  # (G,) int64 wavelength per ghost


def ghost_stack_tables(lens: LensPrescription, pairs=None, pupil_samples: int = 32) -> GhostStackTables:
    """The pupil grid, its disc mask and the event tables of every (pair, wavelength) ghost.

    Made once per lens layout and pupil, on the lens's device, outside a
    captured program (they come from the host).
    """
    pairs = reference_ghost_pairs() if pairs is None else list(pairs)
    dev = lens.curvatures.device
    lin = np.linspace(-1.0, 1.0, pupil_samples)
    gx, gy = np.meshgrid(lin, lin)
    in_disc = (gx**2 + gy**2 <= 1.0).reshape(-1)
    surf, kind, bwd = (np.repeat(a, 3, axis=0) for a in build_event_table(pairs, lens.num_interfaces, lens.aperture_index))
    colors = np.tile(np.arange(3), len(pairs))

    def f32(a):
        return torch.as_tensor(a.reshape(-1), dtype=torch.float32, device=dev)

    return GhostStackTables(
        f32(gx), f32(gy), torch.as_tensor(in_disc, dtype=torch.float32, device=dev), int(in_disc.sum()),
        *(torch.as_tensor(a, device=dev).long() for a in (surf, kind, bwd, colors)),
    )


def render_ghosts_stack(
    lens: LensPrescription,
    angle_to_sun,
    radiance,
    axis_ray,
    width: int,
    height: int,
    pupil_samples: int = 32,
    sensor_scale: float = 0.4,
    intensity: float = 10.0,
    pairs: tuple | None = None,
    tables: GhostStackTables | None = None,
):
    """Physically based ghost buffer (H, W, 3), differentiable in the prescription.

    A collimated beam from the sun (``angle_to_sun``) fills a
    ``pupil_samples``^2 grid masked to the disc of radius ``marginal_r``;
    every (pair, wavelength) ghost is traced by :func:`trace_ghosts_batched`,
    its sensor pattern rotated into the sun's screen direction and scaled by
    ``sensor_scale`` pixels per sensor unit around the sun's pixel, and all
    G x N x 4 bilinear taps are summed into their pixels by
    :func:`ordered_sum`, whose order of adds is fixed, so the buffer is the
    same on every run, on the card too.  ``radiance`` (3,)
    scales the channels; ``pairs`` defaults to ``reference_ghost_pairs()``.
    ``tables``: :func:`ghost_stack_tables` of ``pairs`` and ``pupil_samples``
    made ahead (a captured program's way); made here when None.  With
    tensors on the lens's device for the sun's angle, radiance and axis,
    nothing is copied from the host.
    """
    dev = lens.curvatures.device
    if tables is None:
        tables = ghost_stack_tables(lens, pairs, pupil_samples)

    def arg(a):
        """A tensor or array keeps its dtype; a Python number or list takes the lens's, as JAX's weak types do."""
        if isinstance(a, (torch.Tensor, np.ndarray, np.generic)):
            return torch.as_tensor(a, device=dev)
        return torch.as_tensor(a, dtype=lens.curvatures.dtype, device=dev)

    angle, axis_ray, radiance = arg(angle_to_sun), arg(axis_ray), arg(radiance)
    dt = torch.promote_types(lens.curvatures.dtype, angle.dtype)

    # collimated beam from the sun, meridional angle
    d0 = torch.stack([torch.sin(angle), torch.zeros_like(angle), torch.cos(angle)]).to(dt)
    # static pupil grid and disc mask, float32 as in the JAX package
    o0 = torch.stack([tables.gx.to(dt) * lens.marginal_r, tables.gy.to(dt) * lens.marginal_r,
                      torch.full((tables.gx.shape[0],), -1.0, dtype=dt, device=dev)], dim=-1)

    gb_x = torch.ceil(axis_ray[0] * width)
    gb_y = torch.ceil(axis_ray[1] * height)
    screen_angle = torch.atan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = torch.cos(screen_angle), torch.sin(screen_angle)

    # one ghost per (pair, wavelength), all traced in lockstep
    g = tables.colors.shape[0]
    tr = trace_ghosts_batched(lens, o0.expand(g, -1, -1), d0.expand(g, o0.shape[0], 3), tables.colors,
                              tables.surf, tables.kind, tables.bwd)
    xs, ys = tr.xy[..., 0], tr.xy[..., 1]  # (G, N)

    # rotate the sensor pattern into the sun's screen direction; a tap is
    # clamped to two pixels outside the film before the integer cast (an
    # out-of-range index aborts a CUDA process), which moves no tap that
    # lands on the film and keeps every clamped one at weight 0
    fx = torch.clamp(gb_x + (ca * xs - sa * ys) * sensor_scale, -2.0, width + 1.0)
    fy = torch.clamp(gb_y + (sa * xs + ca * ys) * sensor_scale, -2.0, height + 1.0)
    w = tr.energy * tables.disc * (intensity / tables.n_rays)
    ch = tables.colors[:, None]

    x0, y0 = torch.floor(fx), torch.floor(fy)
    idxs, vals = [], []
    for dx_o in (0, 1):
        for dy_o in (0, 1):
            xi = (x0 + dx_o).to(torch.int64)
            yi = (y0 + dy_o).to(torch.int64)
            wgt = (1 - torch.abs(fx - (x0 + dx_o))) * (1 - torch.abs(fy - (y0 + dy_o)))
            inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
            idxs.append((torch.clamp(yi * width + xi, 0, height * width - 1) * 3 + ch).reshape(-1))
            vals.append((w * wgt * inb.to(w.dtype)).reshape(-1))
    buf = ordered_sum(torch.cat(idxs), torch.cat(vals).to(dt), height * width * 3)
    return buf.reshape(height, width, 3) * radiance


def ordered_sum(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size).index_add(0, idx, vals)`` with its adds in an order fixed by the data alone.

    ``index_add`` on CUDA adds with float atomics, whose order changes from
    run to run.  Here the taps are stably sorted by index, a segmented
    inclusive scan (log2(n) steps, each adding the partial sum ``d`` places
    back where it belongs to the same index) sums each run of equal
    indices, and each run's last partial sum is written to its index (the
    other lanes write to a slot past the end, which is dropped).  Every
    shape is the taps', so nothing waits for the host; differentiable in
    ``vals`` (the backward is gathers and the scan's shifts, in a fixed
    order too).  A prefix sum over all taps differenced at the runs' ends
    would lose small taps against a large prefix; the segmented scan adds
    only taps of one index.
    """
    keys, order = torch.sort(idx, stable=True)
    v = vals[order]
    n, d = v.shape[0], 1
    while d < n:
        same = keys[d:] == keys[:-d]
        v = torch.cat([v[:d], torch.where(same, v[d:] + v[:-d], v[d:])])
        d *= 2
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    slot = torch.where(last, keys, size)
    return torch.zeros(size + 1, dtype=vals.dtype, device=vals.device).scatter(0, slot, v)[:size]
