"""Orbit traffic: one client renders flared frames while the camera sweeps an arc, one step a frame.

Frame ``g`` sets the camera's orbit angle (``theta``, the axis the
turntable turns about) to ``orbit_thetas(...)[g]`` and the render seed to
``Driver.frame_seed(g)``, renders the film (``Renderer.render``), adds the
flare (``Renderer.composite_flare``), copies it to the host and tone-maps
it to 8 bits (the program's ``to_color``, then the levels a PNG stores).
The sweep turns at the ends of the traffic's ``arc``, where the sun stays
on screen, and starts at an angle drawn from the seed; a view comes again
within a window, its samples do not.
"""

from __future__ import annotations

from benchlib import flare_ref
from benchlib.driver import Driver as Base
from benchlib.driver import rng_for
from benchlib.reference import Reference, to_8bit
from benchlib.reference import to_color as ref_to_color
from benchlib.scene import mask, orbit_thetas


class Driver(Base):
    flare = True

    def setup(self) -> None:
        super().setup()
        from lens_flare_tpu_torch.utils.image import to_color

        self._to_color = to_color
        lo, hi = self.traffic["arc"]
        self.start = lo + (hi - lo) * float(rng_for(self.seed, 2).random())
        self.theta0 = self.home_camera().theta
        self._refs = {}

    def theta(self, g: int) -> float:
        return orbit_thetas(self.theta0, tuple(self.traffic["arc"]), float(self.traffic["step"]), self.start, g + 1)[g]

    def frame(self, g: int):
        cam = self.r.camera
        cam.theta = self.theta(g)
        cam.compute_position()
        self.r.seed = self.frame_seed(g)
        with self.spans("render"):
            hdr, _ = self.r.render(progress=False)
        with self.spans("composite"):
            flared = self.r.composite_flare(hdr)
        with self.spans("to_host"):
            host = flared.cpu().numpy()
        with self.spans("tone_map"):
            u8 = to_8bit(self._to_color(host))
        return {"hdr": hdr, "flared": flared, "u8": u8}

    def got(self, out, px, py) -> dict:
        return {"hdr": out["hdr"][py, px], "u8": out["u8"][py.cpu().numpy(), px.cpu().numpy()],
                "flare": out["flared"] - out["hdr"]}

    def expected(self, g: int, px, py, lowp: bool) -> dict:
        if lowp not in self._refs:
            self._refs[lowp] = Reference(self.terrain, dict(self.settings, seed=self.render_seed),
                                         self.device, lowp=lowp)
        ref = self._refs[lowp]
        ref.seed = self.frame_seed(g)
        cam = self.home_camera()
        cam.theta = self.theta(g)
        cam.compute_position()
        hdr = ref.tiled(ref.camera(cam.params()), px, py, self.width, self.height)
        f = self.cfg["flare"]
        ghosts, burst, glow = flare_ref.flare(
            self.terrain, cam, mask(f["ghost_mask"]), mask(f["aperture_mask"]), self.width, self.height,
            f["flare_intensity"], f["flare_radius"], ref.seed, self.device, lowp=lowp,
        )
        flared = ((hdr + ghosts[py, px]) + burst[py, px]) + glow[py, px]
        return {"hdr": hdr, "u8": to_8bit(ref_to_color(flared.cpu().numpy())), "flare": (ghosts + burst) + glow}
