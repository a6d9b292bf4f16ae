"""Host seconds of the harness's ``load`` span in set-up: the renderer built and
``Renderer.load_flat_scene`` (the trees built and uploaded; the viewer's
``Application`` too).  Moves ``setup_s``."""


def read(ctx):
    return ctx.get("load_s") or None
