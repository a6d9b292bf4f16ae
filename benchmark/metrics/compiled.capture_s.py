"""Host seconds the program's captured programs took to warm up, capture and
instantiate (``Programs.capture_s`` of the renderer's frame and ghost-buffer
programs).  Moves ``setup_s``."""


def read(ctx):
    return ctx.get("capture_s") or None
