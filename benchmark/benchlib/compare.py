"""The numbers that decide ``correct``: the program's frames against the plain reference.

Each checked frame is compared at a sample of its pixels drawn from the
seed (and the flare over the whole film).  A number is a share of pixels
that are off, pooled over the checked frames, or the flare's relative
error, the worst frame's; each has its limit in the cell's workload file
(``limits``), set from the readings that ``PERF.md`` gives.

- ``hdr_off``: pixels whose float radiance differs from the reference's by
  more than ``REL`` of the pixel's largest channel (at least 1e-3);
- ``count_off``: pixels whose adaptive sample count differs;
- ``ldr_off``: pixels whose 8-bit value differs by a level or more;
- ``disp_off``: pixels whose display value (the viewer's tone-mapped float
  output) differs by more than ``DISP``;
- ``flare_err``: sum |program flare - reference flare| / sum |reference
  flare| over the film, the program's flare read as its composite minus
  its film.
"""

from __future__ import annotations

import numpy as np
import torch

REL = 1e-4
DISP = 2e-5


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def frame_numbers(got: dict, want: dict, detail: list | None = None) -> dict:
    """Per-frame off counts: {number: (off, total)} or, for ``flare_err``, (error, 1).

    ``detail``: a list that gains (number, sample index, got, want) for every pixel that is off.
    """
    out = {}

    def note(name, off, p, r):
        if detail is not None:
            detail.extend((name, int(i), p[i].tolist(), r[i].tolist()) for i in np.flatnonzero(off))
        return int(off.sum()), len(off)

    if "hdr" in want:
        p, r = _np(got["hdr"]).astype(np.float64), _np(want["hdr"]).astype(np.float64)
        scale = np.maximum(np.abs(r).max(axis=1), 1e-3)
        out["hdr_off"] = note("hdr_off", np.abs(p - r).max(axis=1) / scale > REL, p, r)
    if "counts" in want:
        p, r = _np(got["counts"]), _np(want["counts"])
        out["count_off"] = note("count_off", p != r, p, r)
    if "u8" in want:
        p, r = _np(got["u8"]).astype(np.int64), _np(want["u8"]).astype(np.int64)
        out["ldr_off"] = note("ldr_off", (p != r).any(axis=1), p, r)
    if "disp" in want:
        p, r = _np(got["disp"]).astype(np.float64), _np(want["disp"]).astype(np.float64)
        out["disp_off"] = note("disp_off", np.abs(p - r).max(axis=1) > DISP, p, r)
    if "flare" in want:
        p, r = got["flare"].double(), want["flare"].double()
        out["flare_err"] = (float((p - r).abs().sum() / torch.clamp_min(r.abs().sum(), 1e-30)), 1)
    return out


def pool(per_frame: dict) -> dict:
    """{number: value} over the checked frames: shares pooled, ``flare_err`` the worst frame's."""
    vals = {}
    for numbers in per_frame.values():
        for name, (a, b) in numbers.items():
            if name == "flare_err":
                vals[name] = max(vals.get(name, 0.0), a)
            else:
                off, tot = vals.get(name, (0, 0))
                vals[name] = (off + a, tot + b)
    return {k: (v if k == "flare_err" else v[0] / max(v[1], 1)) for k, v in vals.items()}


def judge(per_frame: dict, limits: dict) -> tuple[bool, int, dict]:
    """(correct, frames failed, {number: (value, limit)}) against the cell's limits."""
    pooled = pool(per_frame)
    missing = set(pooled) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    failed = sum(
        1 for numbers in per_frame.values()
        if any(v > limits[k] for k, v in pool({0: numbers}).items())
    )
    checks = {k: (v, limits[k]) for k, v in pooled.items()}
    return all(v <= lim for v, lim in checks.values()), failed, checks
