#!/usr/bin/env python3
"""The readings that a cell's limits are set from: sound runs of the program and the control.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... [--control-seeds 11,12,13] [--out PATH]

For each seed, in one process: the cell's set-up and warm-up, as many
frames as the cell's check draws from (``check.from_first``), and the
check of the frames a run would check, against the plain reference (the
lower readings).  For each control seed, the control in the program's
place: the reference in the precision below the configuration's
(``Reference(lowp=True)``, and TF32 in the flare's matrix products),
checked the same way (the upper readings).  Prints one JSON line per seed
and writes them all to ``--out``.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    from benchlib import compare, manifest
    from benchlib.driver import rng_for
    from benchlib.profiling import Spans

    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(args.workload)
    check = cell.workload["check"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        spans = Spans()
        drv = manifest.driver(cell.traffic["kind"], cell.bench_dir)(cell.config, cell.traffic, seed, "cuda", spans)
        drv.setup()
        warm = int(cell.traffic["warm_frames"])
        for g in range(warm):
            drv.frame(g)
        n = int(check["from_first"])
        drawn = {int(i) for i in rng_for(seed, 3).choice(n, int(check["frames"]), replace=False)} | {n - 1}
        kept = {}
        t0 = time.perf_counter()
        for i in range(n):
            out = drv.frame(warm + i)
            if i in drawn:
                kept[warm + i] = out
        torch.cuda.synchronize()
        frames_s = time.perf_counter() - t0
        drv.release()
        t0 = time.perf_counter()
        detail = []
        sound = compare.pool(drv.check(kept, int(check["pixels"]), detail=detail))
        check_s = time.perf_counter() - t0
        row = {"workload": args.workload, "seed": seed, "frames_s": frames_s, "check_s": check_s, "sound": sound,
               "off_pixels": detail[:20]}
        if seed in control:
            t0 = time.perf_counter()
            row["control"] = compare.pool(drv.check(kept, int(check["pixels"]), control=True))
            row["control_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del drv, kept
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
