"""Device ms of the sky's sampling on one tile: the program's ``envlight.sample_env``
(one NEE slot) and ``sample_dir`` (the miss lookup, which the program runs on
every camera lane) on 65,536 lanes of the cell's own camera wavefront, the
kernels' durations summed from a profiler trace of 20 calls after the traced
slice (the driver's ``roofline()``).  Moves ``frame_s``."""


def read(ctx):
    r = ctx.get("roofline")
    return r.get("sky_sample_ms") or None if r else None
