"""Percent of the lanes handed to the trace kernels that carried a live ray, over the last frame before the
driver's ``roofline()``: 100 x ``RenderStats.total_rays`` (camera, bounce and shadow rays with t_hi > 0)
over the lanes the frame handed to kernels A, B, C and D (``KERNELS[k].lanes``: camera, bounce and shadow
wavefronts, padding and dead lanes included).  What lane compaction would act on.  None where the program
counts no lanes.  Moves ``frame_s``."""


def read(ctx):
    r = ctx.get("roofline")
    return r.get("live_lane_share") if r else None
