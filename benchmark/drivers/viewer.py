"""Viewer traffic: the interactive ``Application`` in RENDER mode, one progressive frame per call.

Set-up builds the renderer and its ``Application`` (``progressive_batch``
samples a frame) and presses ``r``, which starts the progressive render.
Frame ``g`` calls ``Application.frame()``, which adds a sample to every
pixel of the film and returns the tone-mapped film as a host array.  Every
``orbit_every`` frames the user orbits the camera one step first: ``v``
(VISUALIZE), ``q`` (the keyboard orbit), ``r`` (back to RENDER, which
restarts the accumulation).  The traffic holds no flare: the viewer shows
the film alone.
"""

from __future__ import annotations

import torch

from benchlib.driver import Driver as Base
from benchlib.reference import Reference
from benchlib.reference import to_color as ref_to_color


class Driver(Base):

    def setup(self) -> None:
        from lens_flare_tpu_torch.app import Application

        super().setup()
        self.every = int(self.traffic["orbit_every"])
        with self.spans("load"):
            self.app = Application(self.r, progressive_batch=int(self.traffic["progressive_batch"]))
            self.app.keyboard_event("r")
        self._refs = {}

    def frame(self, g: int):
        if g > 0 and g % self.every == 0:
            with self.spans("orbit"):
                for key in ("v", "q", "r"):
                    self.app.keyboard_event(key)
        with self.spans("render"):
            return {"disp": self.app.frame()}

    def release(self) -> None:
        self.app = None
        super().release()

    def got(self, out, px, py) -> dict:
        return {"disp": out["disp"][py.cpu().numpy(), px.cpu().numpy()]}

    def expected(self, g: int, px, py, lowp: bool) -> dict:
        if lowp not in self._refs:
            self._refs[lowp] = Reference(self.terrain, dict(self.settings, seed=self.render_seed),
                                         self.device, lowp=lowp)
        ref = self._refs[lowp]
        if int(self.traffic["progressive_batch"]) != 1:
            raise ValueError("the reference adds one sample a frame, as a progressive batch of 1 does")
        cam = self.home_camera()
        for _ in range(g // self.every):  # the keyboard orbit: Application._orbit(1.0, 0.0)
            cam.rotate_by(-0.0 * (torch.pi / self.height), -1.0 * (torch.pi / self.width))
        n = min(g % self.every + 1, int(self.settings["ns_aa"]))
        hdr = ref.progressive(ref.camera(cam.params()), px, py, self.width, self.height, n)
        return {"disp": ref_to_color(hdr.cpu().numpy())}
