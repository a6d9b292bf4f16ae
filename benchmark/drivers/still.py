"""Still traffic: one client renders the file camera's view of config 1 again and again, a fresh render seed a frame.

Set-up makes the scene from the seed (:mod:`benchlib.cornell_scene`) and
writes its ``.dae`` on the host; then, inside the ``load`` span, it runs the
command line's path for config 1 (``-s 16 -m 5 --indirect``, no flare): a
``Renderer`` with the configuration's and the traffic's settings, and
``Renderer.load`` of the file (the COLLADA parse, the camera placed from
the file, the tree built and uploaded).  Each frame renders the film
(``Renderer.render``, every pixel's 16 samples summed, no adaptive stop)
under a render seed of its own (``Driver.frame_seed``), copies it to the
host and tone-maps it to 8 bits, each in its span, as the command line
does before its PNG (the encode is left out).  The view never moves, so
no frame's request repeats another's.

The check recomputes the kept frames with
:class:`benchlib.cornell_ref.CornellReference`.  ``roofline()`` times
kernels A and C alone on the cell's wavefronts
(:mod:`benchlib.brute_roofline`) and adds ``live_lane_share``: 100 x the
live rays the last frame traced (``RenderStats.total_rays``: camera,
bounce and shadow rays whose t_hi > 0) over the lanes that frame handed to
the trace kernels A, B, C and D (``KERNELS[k].lanes``), where the program
counts lanes.
"""

from __future__ import annotations

import shutil
import tempfile

import torch

from benchlib import brute_roofline, cornell_scene, sky_scene
from benchlib.cornell_ref import CornellReference
from benchlib.driver import Driver as Base
from benchlib.manifest import ROOT
from benchlib.reference import to_8bit
from benchlib.reference import to_color as ref_to_color


def handed_lanes():
    """The lanes handed to trace kernels A-D so far, or None where the program does not count them."""
    from lens_flare_tpu_torch.ops.intersect_cuda import KERNELS

    counts = [getattr(KERNELS[k], "lanes", None) for k in "ABCD"]
    return None if None in counts else sum(counts)


class Driver(Base):

    def setup(self) -> None:
        from lens_flare_tpu_torch.renderer import Renderer
        from lens_flare_tpu_torch.utils.image import to_color

        with self.spans("scene"):
            self.scene = cornell_scene.make(self.cfg["scene"], self.seed)
            (ROOT / ".bench_cache").mkdir(exist_ok=True)
            tmp = tempfile.mkdtemp(prefix="still_", dir=ROOT / ".bench_cache")  # removed after the load
            dae = cornell_scene.write(self.scene, tmp)
        with self.spans("load"):
            self.r = Renderer(width=self.width, height=self.height, seed=self.render_seed, device=self.device,
                              **self.settings)
            self.r.load(dae)
        shutil.rmtree(tmp, ignore_errors=True)  # the program holds what it read
        self._to_color = to_color
        self._refs = {}
        self.traced = None  # (live rays, lanes handed to A-D) of the last frame

    def home_camera(self):
        return sky_scene.home_camera(self.scene, self.width, self.height)

    def frame(self, g: int):
        self.r.seed = self.frame_seed(g)
        before = handed_lanes()
        with self.spans("render"):
            hdr, _ = self.r.render(progress=False)
        self.traced = None if before is None else (self.r.stats.total_rays, handed_lanes() - before)
        with self.spans("to_host"):
            host = hdr.cpu().numpy()
        with self.spans("tone_map"):
            u8 = to_8bit(self._to_color(host))
        return {"hdr": hdr, "u8": u8}

    def roofline(self) -> dict:
        """Kernels A and C against their bounds (``share`` 0 where they were not timed: no card, or not a
        brute-mode scene), and the last frame's ``live_lane_share``."""
        out = None
        if torch.device(self.device).type == "cuda":
            lights = {"type": self.scene.light_type, "position": self.scene.light_position,
                      "direction": self.scene.light_direction}
            out = brute_roofline.measure(self.r, lights, self.render_seed)
        out = out or {"rows": {}, "share": 0.0}
        if self.traced is not None and self.traced[1] > 0:
            out["live_lane_share"] = 100.0 * self.traced[0] / self.traced[1]
        return out

    def got(self, out, px, py) -> dict:
        return {"hdr": out["hdr"][py, px], "u8": out["u8"][py.cpu().numpy(), px.cpu().numpy()]}

    def expected(self, g: int, px, py, lowp: bool) -> dict:
        if lowp not in self._refs:
            self._refs[lowp] = CornellReference(self.scene, dict(self.settings, seed=self.render_seed), self.device,
                                                lowp=lowp)
        ref = self._refs[lowp]
        ref.seed = self.frame_seed(g)
        cam = ref.camera(self.home_camera().params())
        hdr = ref.still(cam, px, py, self.width, self.height, int(self.settings["ns_aa"]))
        return {"hdr": hdr, "u8": to_8bit(ref_to_color(hdr.cpu().numpy()))}
