"""Percent: the sum of the bounds over the sum of the device times of the
cell's trace kernels, each timed alone (CUDA events) on the cell's camera,
bounce and shadow wavefronts; bounds count the work the function needs
(``benchlib/roofline.py``).  Moves ``frame_s``."""


def read(ctx):
    r = ctx.get("roofline")
    return 100.0 * r["share"] if r and r["share"] > 0 else None
