"""Turntable: orbit the camera around a COLLADA scene and render a frame sequence.

Counterpart of ``tools/turntable.py``, with the same flags, defaults and
file names, plus ``--device`` as in ``cli.py``: the frames render on the
CUDA card unless ``--device cpu`` asks for the CPU.  Example::

    python -m lens_flare_tpu_torch.turntable scene.dae --frames 12 --out turntable \\
        --size 256 256 -s 4 -m 2

Each frame is written to ``OUT/frame_{i:03d}.png``, and then the camera
orbits by ``2 pi / frames`` (``Camera.rotate_by``).  The camera's
``frame_dump_dir`` is ``OUT/frames``, so each move dumps the settings it
leaves (the reference's turntable scripting, camera.cpp:175-180):
``frames/frame_{i+1}.txt`` holds frame i's camera, and
``python -m lens_flare_tpu_torch.cli -c OUT/frames/frame_{i+1}.txt -r W H -s
SPP -m DEPTH -f again.png scene.dae`` renders frame i again, bit for bit.
The camera is an input of the renderer's captured programs (``compiled.py``),
so on the card frame 0 captures them and every later frame replays them;
each frame's line gives its seconds (render and PNG) and the programs held.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lens-flare-tpu-torch-turntable", description=__doc__.splitlines()[0])
    p.add_argument("scene")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--out", default="turntable")
    p.add_argument("--size", type=int, nargs=2, default=[256, 256])
    p.add_argument("-s", type=int, default=4, dest="spp")
    p.add_argument("-m", type=int, default=2, dest="depth")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default) or on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .renderer import Renderer
    from .utils import image as img

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    r = Renderer(
        width=args.size[0],
        height=args.size[1],
        ns_aa=args.spp,
        max_ray_depth=args.depth,
        indirect=args.depth > 1,
        device=args.device,
    )
    r.load(args.scene)
    r.camera.frame_dump_dir = str(out / "frames")

    d_theta = 2 * math.pi / args.frames
    for i in range(args.frames):
        t0 = time.perf_counter()
        hdr, _ = r.render(progress=False)
        img.save_hdr_png(out / f"frame_{i:03d}.png", hdr.cpu().numpy(), flip_y=True)  # film is bottom-up
        print(f"[Turntable] frame {i + 1}/{args.frames}: {time.perf_counter() - t0:.4f} sec, "
              f"{len(r._programs)} programs, capture {r._programs.capture_s:.4f} sec")
        r.camera.rotate_by(0.0, d_theta)

    print(f"[Turntable] wrote {args.frames} frames to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
