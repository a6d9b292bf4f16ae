"""What every traffic driver shares: the terrain, the program's renderer, frame seeds, pixel samples, the check.

A driver (``benchmark/drivers/<kind>.py``) subclasses :class:`Driver` and
supplies ``frame(g)`` (frame ``g`` of the run, warm-up frames first: what the
program returns for it), ``expected(g, px, py, lowp)`` (the plain
reference's values at pixels (px, py)) and ``got(out, px, py)`` (the
program's outputs at the same pixels).
"""

from __future__ import annotations

import numpy as np
import torch

from . import compare, program
from .scene import OrbitCamera, terrain


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A NumPy generator drawn from the run's seed and a purpose tag."""
    return np.random.default_rng([seed % (1 << 63), *tags])


class Driver:
    flare = False

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, spans):
        self.cfg, self.traffic = cfg, traffic
        self.seed = seed % (1 << 63)
        self.render_seed = seed % (1 << 32)
        self.device = device
        self.spans = spans
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        # the renderer's settings: the configuration's, then the traffic's (samples per pixel)
        self.settings = {**cfg["render"], **traffic.get("render", {})}
        self.r = None

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        with self.spans("terrain"):
            self.terrain = terrain(int(self.cfg["scene"]["n_quads"]), self.seed)
        with self.spans("load"):
            self.r = program.renderer(self.cfg, self.settings, self.width, self.height, self.render_seed, self.device, self.flare,
                                      **self.render_kw())
            self.r.load_flat_scene(program.flat_scene(self.terrain))

    def frame_seed(self, g: int) -> int:
        """The render seed of frame ``g`` (every sample's threefry key, the flare's falloff key): drawn
        from the run's seed and ``g``, so that no two frames of a run are the same request."""
        return int(np.random.SeedSequence([self.seed, 4, g]).generate_state(1)[0])

    def render_kw(self) -> dict:
        """More ``Renderer`` fields, which may depend on the terrain."""
        return {}

    def home_camera(self) -> OrbitCamera:
        """The reference's copy of the camera ``load_flat_scene`` places."""
        return OrbitCamera.for_scene(self.terrain.bbox_min, self.terrain.bbox_max)

    def capture_s(self) -> float:
        return program.capture_s(self.r)

    def programs(self) -> int:
        return program.programs(self.r)

    def roofline(self) -> dict:
        return program.trace_roofline(self.r, self.terrain, int(self.r.tile_pixels), self.render_seed)

    def release(self) -> None:
        """Drop the program's renderer and whatever holds it."""
        self.r = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------

    def pixels(self, g: int, n: int):
        """``n`` distinct pixels of frame ``g``, drawn from the seed."""
        n = min(n, self.width * self.height)
        idx = rng_for(self.seed, 1, g).choice(self.width * self.height, size=n, replace=False)
        dev = torch.device(self.device)
        return (torch.as_tensor(idx % self.width, dtype=torch.int64, device=dev),
                torch.as_tensor(idx // self.width, dtype=torch.int64, device=dev))

    def check(self, kept: dict, n_pixels: int, control: bool = False, detail: list | None = None) -> dict:
        """{frame: numbers} of the kept frames against the reference; ``control``: the reference in
        the lower precision stands in the program's place (``kept``'s outputs are not read);
        ``detail`` gains (frame, pixel x, pixel y, number, got, want) for every pixel that is off."""
        per_frame = {}
        for g, out in sorted(kept.items()):
            px, py = self.pixels(g, n_pixels)
            want = self.expected(g, px, py, lowp=False)
            got = self.expected(g, px, py, lowp=True) if control else self.got(out, px, py)
            off = None if detail is None else []
            per_frame[g] = compare.frame_numbers(got, want, off)
            for name, i, p, r in off or ():
                detail.append((g, int(px[i]), int(py[i]), name, p, r))
        return per_frame

    def frame(self, g: int):
        raise NotImplementedError

    def expected(self, g: int, px, py, lowp: bool) -> dict:
        raise NotImplementedError

    def got(self, out, px, py) -> dict:
        raise NotImplementedError
