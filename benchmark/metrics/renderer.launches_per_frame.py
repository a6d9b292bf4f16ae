"""Device kernel launches per frame in the traced slice (copies and fills not
counted).  Moves ``frame_s``."""


def read(ctx):
    t = ctx.get("trace")
    return t["kernels"] / t["frames"] if t and t["kernels"] else None
