"""Percent of the traced slice's wall time in which no operation ran on the
device: 100 * (1 - union of device intervals / wall).  Moves ``frame_s``."""


def read(ctx):
    t = ctx.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
