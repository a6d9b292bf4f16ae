"""Repeated-view traffic: one client renders one autofocused thin-lens view, a fresh render each frame.

Set-up builds the renderer and autofocuses it once at the film's centre
(``Renderer.autofocus``).  Every frame renders the film with the adaptive
stages (``Renderer.render``) under a render seed of its own
(``Driver.frame_seed``), copies it to the host and tone-maps it to 8 bits:
the same view, a new sample set each time, so no frame repeats another.
A seed decides which pixels survive each adaptive stage, hence the widths
the last chunk of a stage pads to; set-up captures the programs of every
width a frame can pad to, so no seed captures one inside the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib.driver import Driver as Base
from benchlib.reference import Reference, to_8bit
from benchlib.reference import to_color as ref_to_color
from benchlib.scene import mask


def chunk_widths(tile: int) -> list:
    """Every width an adaptive stage's chunk pads to: ``renderer.py:pad_lanes``' buckets, multiples of
    ``_adaptive_render``'s grain (8192 lanes for tiles over 16,384, else 256) up to the tile."""
    grain = 8192 if tile > 16384 else 256
    return list(range(grain, tile + 1, grain))


class Driver(Base):

    def lens_radius(self) -> float:
        return float(self.cfg["lens_radius_of_diagonal"]) * float(
            np.linalg.norm(self.terrain.bbox_max - self.terrain.bbox_min))

    def render_kw(self) -> dict:
        return {"lens_radius": self.lens_radius()}

    def setup(self) -> None:
        from lens_flare_tpu_torch.utils.image import to_color

        super().setup()
        self._to_color = to_color
        with self.spans("autofocus"):
            self.r.autofocus(self.width / 2, self.height / 2)
        with self.spans("chunk_widths"):
            self.warm_chunk_widths()
        self._refs = {}

    def warm_chunk_widths(self) -> None:
        """One sample of ``Renderer.render_chunk`` at every chunk width: its programs are captured."""
        from lens_flare_tpu_torch import _rng
        from lens_flare_tpu_torch.scene.camera import camera_params

        r, dev = self.r, torch.device(self.device)
        cam = camera_params(r.camera, dev)
        key = _rng.prng_key(r.seed, device=dev)
        for w in chunk_widths(int(r.tile_pixels)):
            lane = torch.arange(w, device=dev) % (self.width * self.height)
            r.render_chunk(cam, key, lane % self.width, lane // self.width, torch.ones(w, dtype=torch.bool, device=dev),
                           0, 1)

    def frame(self, g: int):
        self.r.seed = self.frame_seed(g)
        with self.spans("render"):
            hdr, counts = self.r.render(progress=False)
        with self.spans("to_host"):
            host = hdr.cpu().numpy()
        with self.spans("tone_map"):
            u8 = to_8bit(self._to_color(host))
        return {"hdr": hdr, "counts": counts, "u8": u8}

    def got(self, out, px, py) -> dict:
        return {"hdr": out["hdr"][py, px], "counts": out["counts"][py, px],
                "u8": out["u8"][py.cpu().numpy(), px.cpu().numpy()]}

    def expected(self, g: int, px, py, lowp: bool) -> dict:
        rc = self.settings
        if lowp not in self._refs:
            ref = Reference(self.terrain, dict(rc, seed=self.render_seed), self.device,
                            bokeh=mask(self.cfg["bokeh_mask"]), lowp=lowp)
            cam = self.home_camera()
            cam.lens_radius = self.lens_radius()
            cam.focal_distance = ref.focus(ref.camera(cam.params()), 0.5, 0.5)
            self._refs[lowp] = (ref, ref.camera(cam.params()))
        ref, cam = self._refs[lowp]
        ref.seed = self.frame_seed(g)
        hdr, counts = ref.adaptive(cam, px, py, self.width, self.height, int(rc["ns_aa"]),
                                   int(rc["samples_per_batch"]), float(rc["max_tolerance"]))
        return {"hdr": hdr, "counts": counts, "u8": to_8bit(ref_to_color(hdr.cpu().numpy()))}
