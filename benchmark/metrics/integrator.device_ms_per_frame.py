"""Device ms per frame inside the harness's ``render`` span, minus the trace
kernels: camera rays, threefry, shading, NEE and bounces, the sums between
replays.  Moves ``frame_s``."""


def read(ctx):
    t = ctx.get("trace")
    if not t or "render" not in t["span_ms"]:
        return None
    return t["span_ms"]["render"] - t["trace_ms"]["render"] or None
