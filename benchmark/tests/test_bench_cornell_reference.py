"""The config-1 cell (``cornell_256_16spp``) against its plain reference: shrunk on the CPU, and at its own size on
the card (``-m gpu``).

A sound run passes; the control (the reference in bfloat16 radiance, the
precision below the configuration's float32) fails; and each fault planted
in the program under a whole run (``harness.run``) turns ``correct`` false:
the mirror sphere dropped from the trace, the spot light's falloff exponent
off by 1, the glass sphere at IOR 1.4 for 1.5, the ceiling emitter not
counted where a camera ray hits it, one sample a pixel fewer (15 for 16 on
the card, 3 for 4 on the CPU), and the previous frame's film handed back.
On the CPU the cell is 48 x 32 at 4 samples a pixel, 1,024-lane tiles,
every pixel checked, on a box whose view shows both spheres, the block and
the emitter.
"""

import io
import json
import time

import numpy as np
import pytest
import torch
from conftest import BENCH

from benchlib import cornell_scene, harness, manifest
from benchlib.cornell_ref import CornellReference
from benchlib.profiling import Spans

CELL = "cornell_256_16spp"
SEED = 2**33 + 5  # its 48 x 32 view shows both spheres, the block and the emitter
CARD_SEED = 2147484511
GLASS, SPOT = 5, 5  # the glass family's code, the spot light's type code


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tests run in several processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny() -> manifest.Cell:
    cell = manifest.load_cell(CELL)
    cell.config["render"]["tile_pixels"] = 1024
    cell.traffic["width"], cell.traffic["height"] = 48, 32
    cell.traffic["render"]["ns_aa"] = 4
    cell.workload["check"]["pixels"] = 48 * 32
    return cell


def run(cell: manifest.Cell, device: str, seed: int = SEED, seconds: float = 1.0):
    """One run of ``cell`` on ``device``, in this process: (result, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    res = harness.run(cell, seed, seconds, False, device, time.perf_counter(), out=out, err=err)
    return res, err.getvalue()


def test_sound_run_is_correct():
    res, err = run(tiny(), "cpu")
    assert res["correct"] and res["failed"] == 0, err
    assert set(res["checks"]) == {"hdr_off", "ldr_off"}
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]


def test_control_is_not_correct():
    cell = tiny()
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, SEED, "cpu", Spans())
    drv.setup()
    frames = [drv.frame(g) for g in range(3)]
    per_frame = drv.check({2: frames[2]}, cell.workload["check"]["pixels"], control=True)
    from benchlib import compare

    correct, _, checks = compare.judge(per_frame, cell.workload["limits"])
    assert not correct, checks
    assert all(v > lim for v, lim in checks.values()), checks  # each number alone refuses the control


def _patch_scene(monkeypatch, edit):
    """``edit(flat_scene)`` applied to every scene the renderer loads."""
    import lens_flare_tpu_torch.renderer as rmod

    real = rmod.load_scene

    def load(path):
        scene, info = real(path)
        edit(scene)
        return scene, info

    monkeypatch.setattr(rmod, "load_scene", load)


def _drop_sphere(monkeypatch):
    """The mirror sphere (the file's first) left out of the trace."""
    def edit(s):
        s.sph_center, s.sph_radius, s.sph_bsdf = s.sph_center[1:], s.sph_radius[1:], s.sph_bsdf[1:]

    _patch_scene(monkeypatch, edit)


def _spot_exponent(monkeypatch):
    """The spot light's falloff exponent 2 read as 3."""
    def edit(s):
        s.lights.dim_x[s.lights.light_type == SPOT, 1] += 1.0

    _patch_scene(monkeypatch, edit)


def _glass_ior(monkeypatch):
    """The glass sphere at IOR 1.4 for 1.5."""
    def edit(s):
        s.bsdfs.ior[s.bsdfs.bsdf_type == GLASS] = 1.4

    _patch_scene(monkeypatch, edit)


def _no_camera_emission(monkeypatch):
    """The emitter's radiance left out where a camera ray hits it (its delta-chain hits still counted)."""
    import lens_flare_tpu_torch.integrator.path as pmod

    real = pmod._shade_plain

    def shade(bundle, settings, tape, k, *a):
        path, nee, ray = real(bundle, settings, tape, k, *a)
        return (path._replace(L0=torch.zeros_like(path.L0)) if k == 0 else path), nee, ray

    monkeypatch.setattr(pmod, "_shade_plain", shade)


def _one_sample_fewer(monkeypatch):
    """Each tile traces one sample a pixel fewer than ``ns_aa`` (15 for 16) and averages those."""
    import lens_flare_tpu_torch.renderer as rmod

    real = rmod.render_wavefront

    def wave(bundle, settings, *a, **k):
        return real(bundle, settings._replace(ns_aa=settings.ns_aa - 1), *a, **k)

    monkeypatch.setattr(rmod, "render_wavefront", wave)


def _previous_film(monkeypatch):
    """Each render hands back the film the render before it made (the first, its own)."""
    import lens_flare_tpu_torch.renderer as rmod

    real, last = rmod.Renderer.render, {}

    def render(self, *a, **k):
        out = real(self, *a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(rmod.Renderer, "render", render)


FAULTS = (_drop_sphere, _spot_exponent, _glass_ior, _no_camera_emission, _one_sample_fewer, _previous_film)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res, err = run(tiny(), "cpu")
    assert not res["correct"] and res["failed"] > 0, err


def test_no_frame_repeats_another(monkeypatch):
    """Every frame asks for a render seed no earlier frame asked for; the view stays the file camera's."""
    import lens_flare_tpu_torch.renderer as rmod

    cell = tiny()
    asked, real = [], rmod.Renderer.render

    def render(self, *a, **k):
        asked.append((np.asarray(self.camera.params().pos).tobytes(), self.seed))
        return real(self, *a, **k)

    monkeypatch.setattr(rmod.Renderer, "render", render)
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 2**33 + 3, "cpu", Spans())
    drv.setup()
    for g in range(5):
        drv.frame(g)
    assert len({s for _, s in asked}) == 5 and len({v for v, _ in asked}) == 1


def test_the_checked_pixels_see_every_part_of_the_scene():
    """At the test's size the checked pixels show the walls, the block, the emitter, both spheres and the
    open side."""
    cell = tiny()
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, SEED, "cpu", Spans())
    drv.setup()
    px, py = drv.pixels(3, cell.workload["check"]["pixels"])
    ref = CornellReference(drv.scene, dict(drv.settings, seed=drv.frame_seed(3)), "cpu")
    cam = ref.camera(drv.home_camera().params())
    hits = ref.first_hits_all(cam, px, py, drv.width, drv.height, 4)
    assert set(hits.tolist()) == set(range(-1, 9))


def test_program_loads_the_written_scene():
    """The driver's renderer holds the scene the benchmark wrote: 22 triangles and 2 spheres, brute mode."""
    cell = tiny()
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, SEED, "cpu", Spans())
    drv.setup()
    assert np.array_equal(drv.r.scene.sph_center, drv.scene.sph_center)
    assert drv.r.bundle.cscene.brute and drv.r.bundle.cscene.n_spheres == 2 and drv.r.bundle.cscene.b1 == 1


def test_cell_files_agree():
    cell = manifest.load_cell(CELL)
    assert cell.entry["why"] == cell.workload["why"] and cell.entry["chips"] == 1
    assert len(cell.entry["why"]) <= 200
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert {m["name"] for m in cell.per_layer} >= {"trace.roofline_share", "trace.live_lane_share"}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "frame_s"}
    assert [c["name"] for c in b["configs"]][-1] == cell.config["name"] == "config1_cornell_spheres"
    assert cell.config["reduced"] == [] and cell.config["render"]["max_ray_depth"] == 5
    assert cell.traffic["render"]["ns_aa"] == 16 and (cell.traffic["width"], cell.traffic["height"]) == (256, 256)
    scene = cornell_scene.make(cell.config["scene"], SEED)
    assert len(scene.tri_p) == 22 and len(scene.sph_center) == 2


# ---------------------------------------------------------------------------
# on the card, at the cell's own size
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct_on_the_card(card, monkeypatch, fault):
    fault(monkeypatch)
    res, err = run(manifest.load_cell(CELL), "cuda", seed=CARD_SEED)
    print(f"[cornell_fault:{fault.__name__.strip('_')}] {json.dumps(res['checks'])} failed {res['failed']}")
    assert not res["correct"] and res["failed"] > 0, err


@pytest.mark.gpu
def test_cell_on_the_card(card):
    """A short run of the cell at its own size on the card, as the driver runs it."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELL, "--seed", str(CARD_SEED),
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-4000:]
