"""``ab_walk.py`` against a baseline whose kernels C and E read the earlier row layouts (commit 34519e0 and older).

    python -m lens_flare_tpu_torch.ab_legacy --baseline DIR [--out PATH]

Such a baseline's ``lf_brute`` reads C's triangle rows as (S_pad, 9), and
its ``lf_tree_closest_mxu`` reads E's coefficients as (B1*B2*K, 4, 16)
(``CudaScene.mxu_coef``).  While the baseline's library is the current one,
C and E launch through :func:`main`'s ``launch``, as that baseline's
wrapper launched them, on each scene's rows in those layouts.  The rows are
made once per scene, at its first such launch: a row's untimed exactness
call or a frame's warm-up, so the timed calls queue only the kernel.  Every
other launch, the checkout's C and E included, goes through
``intersect_cuda._launch`` and its checks.  The steps, rows, outputs and
bit-equality checks are ``ab_walk.py``'s.  PERF.md's times of C and E
against the commit before their rows were repacked come from this script.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from . import ab_walk
from .ops import _build
from .ops import intersect_cuda as ic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="directory holding the baseline intersect.cu")
    ap.add_argument("--out", default=str(ab_walk.DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B measures kernels on a card")
    baseline = str(_build._library_path(Path(args.baseline)))
    checked = ic._launch
    tables = {}  # (id(cs), kernel) -> (cs, its rows in the baseline's layout)

    def launch(key, cs, o, d, t_lo, t_hi, closest, **kw):
        lib = _build._lib
        if key not in ("C", "E") or lib is None or lib._name != baseline:
            return checked(key, cs, o, d, t_lo, t_hi, closest, **kw)
        entry = tables.get((id(cs), key))
        if entry is None:  # cs is kept in the entry, so its id is not reused
            rows = cs.tri_brute[:, :9].contiguous() if key == "C" else cs.mxu_coef
            entry = tables[(id(cs), key)] = (cs, rows)
        n = o.shape[0]
        o, d, t_lo, t_hi = (x.contiguous() for x in (o, d, t_lo, t_hi))
        out = (
            torch.empty((n,), dtype=torch.float32, device=o.device),
            torch.empty((n,), dtype=torch.int32, device=o.device),
            torch.empty((n, 2), dtype=torch.float32, device=o.device),
            torch.empty((n,), dtype=torch.int32, device=o.device),
        )
        rays = [x.data_ptr() for x in (o, d, t_lo, t_hi)]
        outs = [x.data_ptr() for x in out]
        stream = torch.cuda.current_stream(o.device).cuda_stream
        if key == "C":
            rc = lib.lf_brute(*rays, entry[1].data_ptr(), cs.sph.data_ptr(), n, cs.s_real, cs.s_pad,
                              cs.n_spheres, int(closest), *outs, stream)
        else:
            rc = lib.lf_tree_closest_mxu(*rays, cs.top.data_ptr(), cs.child.data_ptr(), entry[1].data_ptr(),
                                         cs.mxu_centers.data_ptr(), cs.sph.data_ptr(), n, cs.b1, cs.b2, cs.k,
                                         cs.n_spheres, *outs, stream)
        if rc != 0:
            raise RuntimeError(f"baseline kernel {ic.KERNELS[key].symbol} failed to launch: cudaError {rc}")
        ic.KERNELS[key].launches += 1
        return out

    ic._launch = launch
    try:
        return ab_walk.main(["--baseline", args.baseline, "--out", args.out])
    finally:
        ic._launch = checked


if __name__ == "__main__":
    main(sys.argv[1:])
