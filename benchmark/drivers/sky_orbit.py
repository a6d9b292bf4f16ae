"""Sky orbit traffic: config 3's flared frames while the camera sweeps an arc about the file's camera.

Set-up makes the scene from the seed (:mod:`benchlib.sky_scene`) and writes
its ``.dae`` and its HALF, ZIP EXR sky on the host; then, inside the
``load`` span, it runs the command line's path for config 3
(``-e sky.exr --lens-model realistic``): ``exr.read``, a ``Renderer`` with
the sky, the realistic lens and the starburst's aperture, and
``Renderer.load`` of the file (the COLLADA parse, the sky's tables, the
tree built and uploaded).  Each frame is the orbit's
(:mod:`drivers.orbit`): the camera at its angle of the sweep, ``render``,
``composite_flare``, the copy to the host and the tone map, each in its
span; the sweep turns at the ends of the traffic's ``arc``, about the
theta the file's camera gives, and every frame asserts that the sun is on
screen.  A frame also keeps the ghost buffer its composite added (the
tensor the flare's captured program returned to ``composite_flare``).

The check recomputes the kept frames with
:class:`benchlib.sky_ref.SkyReference` and :mod:`benchlib.realistic_ref`.
Besides ``compare``'s numbers it gives ``ghost_err``: sum |program ghosts -
reference ghosts| / sum |reference ghosts| over the film, one per frame,
their mean over the checked frames (``compare.pool``), so that the ghost
stack is held to its own precision although its whole share of the flare
is ~1e-5.  The program supplies one thing to the reference: its film,
handed to :meth:`Driver.expected` as the base on which the reference's
flare is composited and then taken away again, as the program's flare is
read (composite minus film), so that ``flare_err`` weighs the flare's terms
and not the float32 rounding of the film's larger values (which alone reads
3e-5 to 3e-4 of a 1080p flare).
"""

from __future__ import annotations

import shutil
import tempfile
import weakref
from types import SimpleNamespace

import torch

from benchlib import compare, program, realistic_ref, rng, roofline, sky_scene
from benchlib.driver import rng_for
from benchlib.manifest import ROOT
from benchlib.profiling import is_kernel, raw_events
from benchlib.reference import to_8bit
from benchlib.reference import to_color as ref_to_color
from benchlib.scene import mask
from benchlib.sky_ref import SkyReference
from drivers.orbit import Driver as Orbit


class Driver(Orbit):
    flare = True

    def setup(self) -> None:
        from lens_flare_tpu_torch.lens.aperture import ApertureTexture
        from lens_flare_tpu_torch.renderer import Renderer
        from lens_flare_tpu_torch.utils import exr
        from lens_flare_tpu_torch.utils.image import to_color

        with self.spans("scene"):
            self.scene = sky_scene.make(self.cfg["scene"], self.cfg["sky"], self.seed)
            (ROOT / ".bench_cache").mkdir(exist_ok=True)
            self._dir = tempfile.mkdtemp(prefix="sky_orbit_", dir=ROOT / ".bench_cache")  # removed after the load
            dae, sky = sky_scene.write(self.scene, self._dir)
        f = self.cfg["flare"]
        with self.spans("load"):
            envmap = exr.read(sky)
            self.r = Renderer(
                width=self.width, height=self.height, seed=self.render_seed, device=self.device, envmap=envmap,
                lens_model=f["lens_model"], aperture=ApertureTexture.from_array(mask(f["aperture_mask"])),
                flare_intensity=f["flare_intensity"], flare_radius=f["flare_radius"], **self.settings,
            )
            self.r.load(dae)
        shutil.rmtree(self._dir, ignore_errors=True)  # the program holds what it read
        # keep the ghost buffer each composite adds: its captured program's output, as handed back; the
        # wrapper holds the programs and the driver weakly, so no cycle keeps a dead renderer's graphs
        programs = self.r._flare_programs
        run, owner, driver = type(programs).run, weakref.ref(programs), weakref.ref(self)

        def run_and_keep(key, fn, *inputs):
            out = run(owner(), key, fn, *inputs)
            if key[0] == "realistic":
                driver()._ghosts = out
            return out

        programs.run = run_and_keep
        self._ghosts = None
        self._to_color = to_color
        lo, hi = self.traffic["arc"]
        self.start = lo + (hi - lo) * float(rng_for(self.seed, 2).random())
        self.theta0 = self.home_camera().theta
        self._refs = {}

    def home_camera(self):
        return sky_scene.home_camera(self.scene, self.width, self.height)

    def frame(self, g: int):
        cam = self.home_camera()
        cam.theta = self.theta(g)
        cam.compute_position()
        x, y = cam.analyze_world_coord(self.scene.light_position[0])
        if not (0 <= x <= 1 and 0 <= y <= 1):
            raise RuntimeError(f"frame {g}: the sun is off screen at ({x}, {y}); narrow the traffic's arc")
        self._ghosts = None
        out = super().frame(g)
        out["ghosts"] = self._ghosts
        return out

    def roofline(self) -> dict | None:
        """The trace kernels' share of their roofline on this scene (shadow rays to the area light's
        centre), and ``sky_sample_ms``: the device ms of the sky's kernels on one tile of the cell's camera
        wavefront, one NEE slot of ``sample_env`` and the miss lookup ``sample_dir`` on every lane (the
        program looks up each camera lane and keeps the misses), summed from a profiler trace."""
        from lens_flare_tpu_torch.integrator.envlight import sample_dir, sample_env
        from lens_flare_tpu_torch.ops import intersect_cuda as ic
        from lens_flare_tpu_torch.scene.camera import camera_params

        lights = SimpleNamespace(light_position=self.scene.light_position)
        lanes = int(self.r.tile_pixels)
        out = program.trace_roofline(self.r, lights, lanes, self.render_seed) or {}
        cs, env = self.r.bundle.cscene, self.r.bundle.env
        if cs is None or env is None or not torch.cuda.is_available():
            return out or None
        cam = camera_params(self.r.camera, torch.device(self.r.device))._asdict()
        closest = ic.tree_closest_shade if cs.shade else ic.tree_closest_hit
        waves = roofline.wavefronts(lambda *rays: closest(cs, *rays), cam, lambda slot: cs.tri[slot, :9],
                                    self.width, self.height, lanes, self.scene.light_position[1], self.render_seed)
        d = waves["camera"][1]
        n = d.shape[0]
        keys = rng.fold_in(rng.prng_key(self.render_seed, d.device).expand(n, 2), torch.arange(n, device=d.device))
        u = rng.uniform(keys, (2,))
        out["sky_sample_ms"] = kernel_ms(lambda: (sample_env(env, u), sample_dir(env, d)))
        return out

    def check(self, kept: dict, n_pixels: int, control: bool = False, detail: list | None = None) -> dict:
        """As :meth:`benchlib.driver.Driver.check`, each frame's film handed to the reference, and
        ``ghost_err`` added to each frame's numbers."""
        per_frame = {}
        for g, out in sorted(kept.items()):
            px, py = self.pixels(g, n_pixels)
            want = self.expected(g, px, py, False, out["hdr"])
            got = self.expected(g, px, py, True, out["hdr"]) if control else self.got(out, px, py)
            off = None if detail is None else []
            per_frame[g] = compare.frame_numbers(got, want, off)
            p, r = got["ghosts"].double(), want["ghosts"].double()
            per_frame[g]["ghost_err"] = (float((p - r).abs().sum() / torch.clamp_min(r.abs().sum(), 1e-30)), 1)
            for name, i, pv, rv in off or ():
                detail.append((g, int(px[i]), int(py[i]), name, pv, rv))
        return per_frame

    def got(self, out, px, py) -> dict:
        return {**super().got(out, px, py), "ghosts": out["ghosts"]}

    def expected(self, g: int, px, py, lowp: bool, film) -> dict:
        """The reference's values at pixels (px, py) of frame ``g``, its ghost buffer, and its flare
        composited on ``film`` (the program's) and taken away again."""
        if lowp not in self._refs:
            self._refs[lowp] = SkyReference(self.scene, dict(self.settings, seed=self.render_seed), self.device,
                                            lowp=lowp)
        ref = self._refs[lowp]
        ref.seed = self.frame_seed(g)
        cam = self.home_camera()
        cam.theta = self.theta(g)
        cam.compute_position()
        hdr = ref.tiled(ref.camera(cam.params()), px, py, self.width, self.height)
        f = self.cfg["flare"]
        ghosts, burst, glow = realistic_ref.flare(
            self.scene, cam, mask(f["aperture_mask"]), self.width, self.height, f["flare_intensity"],
            f["flare_radius"], ref.seed, self.device, lowp=lowp,
        )
        flared = ((hdr + ghosts[py, px]) + burst[py, px]) + glow[py, px]
        return {"hdr": hdr, "u8": to_8bit(ref_to_color(flared.cpu().numpy())),
                "flare": (((film + ghosts) + burst) + glow) - film, "ghosts": ghosts}


def kernel_ms(fn, repeats: int = 20) -> float:
    """Device ms per call of ``fn()``: the durations of the kernels a profiler records over ``repeats``
    calls after one warm-up, summed (the gaps between launches left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.end - e.start for e in raw_events(prof) if e.device and not e.annotation and is_kernel(e.name))
    return ns / 1e6 / repeats
