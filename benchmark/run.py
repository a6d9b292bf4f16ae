#!/usr/bin/env python3
"""The benchmark of ``lens_flare_tpu_torch`` on one NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It makes the cell's inputs from the seed,
loads the program, warms up every shape the cell's traffic uses (set-up),
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON line last.  ``--trace 1`` adds a
profiled slice of frames after the window and reports the per-layer
metrics.  It exits non-zero, printing no result, without a CUDA card, or
when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"  # every build and kernel cache of a run, at a fixed path in the checkout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    from benchlib import harness, manifest

    cell = manifest.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    return 3 if res is None else 0


if __name__ == "__main__":
    sys.exit(main())
