"""The ghost buffers' moments, and the limits that hold two of them together.

A ghost buffer is a sum of splats, which the card and the CPU round in
other orders, so their buffers differ in the last bits.  They are
compared ghost by ghost and channel by channel through moments that do
not magnify those bits: energy on the film, the centroid of that energy
and the RMS radius about it.  ``chip_smoke.py`` holds the card's
realistic ghosts against the CPU's with them; a replayed buffer, which
must equal an eager one bit for bit, reports them beside that finding
(``ab_compiled.py``).
"""

from __future__ import annotations

import torch

# the card's realistic ghosts against the CPU's in float32, the largest difference of one ghost:
# ~20x float32's own rounding on either device (against float64: <= 5.9e-6 in energy and radius,
# 3.2e-5 px in centroid, on an H100)
GHOST_F32 = {"energy": 1e-4, "centroid_px": 1e-3, "radius": 1e-4}


def buffer_moments(buf, axis, name="all"):
    """Each channel of an (H, W, 3) ghost buffer: its energy, the centroid of that energy from the sun's
    pixel (x, y) and its RMS radius about the centroid, as {"name:c": (energy, (x, y), radius)} float64
    tensors on the CPU; ``axis`` is the sun's screen position, (x, y) in [0, 1]."""
    buf = buf.double()
    (height, width), dev = buf.shape[:2], buf.device
    sun = torch.ceil(torch.tensor(axis, dtype=torch.float32, device=dev)
                     * torch.tensor([width, height], device=dev)).double()  # as the splat places it
    px, py = (torch.arange(n, dtype=torch.float64, device=dev) - sun[k] for k, n in enumerate((width, height)))
    mx, my = buf.sum(dim=0), buf.sum(dim=1)  # (W, 3) and (H, 3) marginals
    e = mx.sum(dim=0)
    cx, cy = (px[:, None] * mx).sum(dim=0) / e, (py[:, None] * my).sum(dim=0) / e
    r2 = (((px[:, None] - cx) ** 2 * mx).sum(dim=0) + ((py[:, None] - cy) ** 2 * my).sum(dim=0)) / e
    return {f"{name}:{'rgb'[c]}": (e[c].cpu(), torch.stack([cx[c], cy[c]]).cpu(), r2[c].sqrt().cpu())
            for c in range(3)}


def ghost_errors(got, want):
    """Two ``ghost_moments`` apart, ghost by ghost: {"energy": relative difference, "centroid_px": distance
    in pixels, "radius": relative difference}, each {"i-j:c": value}.  They hold a dim ghost as closely as
    a bright one, and a sub-pixel shift of a sparse splat moves them no more than it moves the ghost.  A
    ghost that puts no energy on the film must do so in both."""
    errs = {"energy": {}, "centroid_px": {}, "radius": {}}
    for key, (e_w, c_w, r_w) in want.items():
        e_g, c_g, r_g = got[key]
        assert (e_g > 0) == (e_w > 0), f"ghost {key} is on the film only on one side"
        if e_w > 0:
            errs["energy"][key] = abs(e_g / e_w - 1).item()
            errs["centroid_px"][key] = (c_g - c_w).norm().item()
            errs["radius"][key] = abs(r_g / r_w - 1).item()
    return errs
