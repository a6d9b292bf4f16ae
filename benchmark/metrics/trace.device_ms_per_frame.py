"""Device ms per frame of the trace kernels (``ops/csrc/intersect.cu``, by
name) inside the harness's ``render`` span.  Moves ``frame_s``."""


def read(ctx):
    t = ctx.get("trace")
    return t["trace_ms"].get("render") or None if t else None
