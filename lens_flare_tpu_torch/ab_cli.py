"""The ``--upsample 1`` command line's wall, another tree's against this one's, on the card.

    python -m lens_flare_tpu_torch.ab_cli --other DIR [--out PATH]

The command is ``chip_smoke.py`` phase 20's: terrain 256's file (131,072
triangles) with ``--upsample 1`` (524,288 triangles) at 1920x1080, 1 spp,
depth 4, the aperture PNGs and the flare.  Each run is a process of its
own whose working directory is one tree (``--other``, or this one); it
calls ``cli.main`` twice, and the second call is timed (host clock around
``cli.main``, as phase 20's ``cli_s``): the first builds the kernels and
warms the process up.  The order is other, this, this, other.  It prints
one JSON line per run, the wall and the command line's lines that give
seconds, and writes them, with the card's ``nvidia-smi`` line, to
``--out`` (default ``_build/ab_cli.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT_OUT = HERE / "_build" / "ab_cli.json"
ORDER = "OTTO"  # O the other tree, T this one

RUN = """
import contextlib, io, json, sys, time
from lens_flare_tpu_torch import cli
for _ in range(2):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        assert cli.main(json.loads(sys.argv[1])) == 0
    wall = time.perf_counter() - t0
lines = [ln for ln in buf.getvalue().replace("\\r", "\\n").splitlines() if "sec" in ln]
print(json.dumps({"cli_s": wall, "lines": lines}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="root of the tree to compare with (a checkout)")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    args = p.parse_args(argv)
    from .lens.aperture import polygon_mask
    from .scene.writer import terrain_dae
    from .utils import image as img

    work = HERE / "_build" / "ab_cli"
    work.mkdir(parents=True, exist_ok=True)
    scene = terrain_dae(256).write(work / "terrain256.dae")
    ap_png, ghost_png = work / "aperture.png", work / "ghost_aperture.png"
    img.save_png(ap_png, polygon_mask(256, 5, rotation=0.3))
    img.save_png(ghost_png, polygon_mask(64, 6))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"O": Path(args.other).resolve(), "T": HERE.parent}
    rows = []
    for i, which in enumerate(ORDER):
        cli_argv = ["-r", "1920", "1080", "-s", "1", "-m", "4", "-x", str(ap_png), "-y", str(ghost_png),
                    "-i", "1.5", "-n", "30", "--upsample", "1", "-f", str(work / f"run{i}.png"),
                    "--device", "cuda", str(scene)]
        tree = trees[which]
        done = subprocess.run([sys.executable, "-c", RUN, json.dumps(cli_argv)], cwd=tree,
                              env={**os.environ, "PYTHONPATH": str(tree)}, capture_output=True, text=True,
                              check=True)
        row = {"run": i, "tree": "other" if which == "O" else "this", **json.loads(done.stdout.splitlines()[-1])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "order": ORDER, "runs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
