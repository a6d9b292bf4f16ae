"""Device ms per frame of the flare: the kernels that start inside the
harness's ``composite`` and ``to_host`` spans (the ghost-buffer replay, the
FFT starburst, the falloff; the copy to the host not counted).  Moves
``frame_s``."""


def read(ctx):
    t = ctx.get("trace")
    if not t or "composite" not in t["kernel_ms"]:
        return None
    return t["kernel_ms"]["composite"] + t["kernel_ms"].get("to_host", 0.0) or None
