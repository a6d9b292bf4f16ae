"""The plain reference against the program at a tiny size on the CPU: sound runs pass, the control and
the faults a cell can have fail.

The control is the reference in the precision below the configuration's
(bfloat16 radiance, TF32 in the flare's matrix products) put in the
program's place.  Each fault breaks the timed path underneath a whole run
(``harness.run`` on the CPU, its look for a card skipped) and must turn
``correct`` false.
"""

import numpy as np
import pytest
import torch
from conftest import CELLS, run_cpu

from benchlib import compare, manifest
from benchlib.profiling import Spans


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res, err = run_cpu(tiny(name))
    assert res["correct"] and res["failed"] == 0, err
    assert err.strip().splitlines()[-1].startswith("check ")
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    cell = tiny(name)
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 2**31 + 5, "cpu", Spans())
    drv.setup()
    frames = [drv.frame(g) for g in range(3)]
    kept = {2: frames[2]}
    correct, _, checks = compare.judge(drv.check(kept, 300, control=True), cell.workload["limits"])
    assert not correct, checks


def _scale_radiance(monkeypatch, cell):
    """An answer altered where it is produced: every sample's radiance 0.1% high."""
    import lens_flare_tpu_torch.renderer as rmod

    real = rmod.radiance_sample
    monkeypatch.setattr(rmod, "radiance_sample", lambda *a, **k: (lambda L, st: (L * 1.001, st))(*real(*a, **k)))


def _drop_half_tiles(monkeypatch, cell):
    """Half of the batch left out: the second half of every wavefront's lanes comes back black."""
    import lens_flare_tpu_torch.renderer as rmod

    real_wave, real_chunk = rmod.render_wavefront, rmod.Renderer.render_chunk

    def wave(*a, **k):
        rad, cnt, st = real_wave(*a, **k)
        half = rad.shape[0] // 2
        return torch.cat([rad[:half], torch.zeros_like(rad[half:])]), cnt, st

    def chunk(self, *a, **k):
        f, s1, s2, st = real_chunk(self, *a, **k)
        half = f.shape[0] // 2
        z = lambda x: torch.cat([x[:half], torch.zeros_like(x[half:])])  # noqa: E731
        return z(f), z(s1), z(s2), st

    monkeypatch.setattr(rmod, "render_wavefront", wave)
    monkeypatch.setattr(rmod.Renderer, "render_chunk", chunk)


def _stale_frames(monkeypatch, cell):
    """A step that returns its state unchanged: the renderer hands back its first frame, the viewer's
    film stops after one sample."""
    import lens_flare_tpu_torch.app as amod
    import lens_flare_tpu_torch.renderer as rmod

    real, first = rmod.Renderer.render, {}

    def render(self, *a, **k):
        if "out" not in first:
            first["out"] = real(self, *a, **k)
        return first["out"]

    monkeypatch.setattr(rmod.Renderer, "render", render)
    monkeypatch.setattr(amod.Application, "render_done",
                        property(lambda self: self._film is not None and self._sample_idx >= 1))


def view(camera) -> bytes:
    """The camera's state as ray generation reads it."""
    return b"".join(np.asarray(v, np.float32).tobytes() for v in camera.params())


def _memo_by_camera(monkeypatch, cell):
    """A cache of finished frames keyed by the view alone: a frame whose camera came before is handed
    back as it was, whatever its render seed or samples.  The orbit's views come again every 20
    frames on the card; here its step is cut so that they come again every 4."""
    import lens_flare_tpu_torch.app as amod
    import lens_flare_tpu_torch.renderer as rmod

    cell.traffic["step"] = 0.5
    memo, real_render, real_frame = {}, rmod.Renderer.render, amod.Application.frame

    def render(self, *a, **k):
        key = ("render", view(self.camera))
        if key not in memo:
            memo[key] = real_render(self, *a, **k)
        return memo[key]

    def frame(self):
        key = ("frame", view(self.renderer.camera))
        if key not in memo:
            memo[key] = real_frame(self)
        return memo[key]

    monkeypatch.setattr(rmod.Renderer, "render", render)
    monkeypatch.setattr(amod.Application, "frame", frame)


FAULTS = (_scale_radiance, _drop_half_tiles, _stale_frames, _memo_by_camera)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    cell = tiny(name)
    fault(monkeypatch, cell)
    res, err = run_cpu(cell, seconds=2.0)
    assert not res["correct"] and res["failed"] > 0, err


@pytest.mark.parametrize("name", CELLS)
def test_no_frame_repeats_another(tiny, monkeypatch, name):
    """Every frame asks for something no earlier frame of the run asked for: its view, its render seed
    or its samples differ (the orbit's views come again, its seeds do not)."""
    import lens_flare_tpu_torch.app as amod
    import lens_flare_tpu_torch.renderer as rmod

    cell = tiny(name)
    cell.traffic["step"] = 0.5
    asked, real_render, real_frame = [], rmod.Renderer.render, amod.Application.frame

    def render(self, *a, **k):
        asked.append((view(self.camera), self.seed))
        return real_render(self, *a, **k)

    def frame(self):
        asked.append((view(self.renderer.camera), self.renderer.seed, self._sample_idx))
        return real_frame(self)

    monkeypatch.setattr(rmod.Renderer, "render", render)
    monkeypatch.setattr(amod.Application, "frame", frame)
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 2**33 + 3, "cpu", Spans())
    drv.setup()
    n = {"orbit": 10, "frames": 3, "viewer": 34}[cell.traffic["kind"]]
    for g in range(n):
        drv.frame(g)
    assert len(asked) == n and len(set(asked)) == n
    assert len({drv.frame_seed(g) for g in range(10_000)}) == 10_000


class CpuGraph:
    """A stand-in for a captured CUDA graph on the CPU: a replay runs the function again into the
    captured outputs."""

    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs

    def replay(self):
        from lens_flare_tpu_torch import compiled

        for o, x in zip(self.outputs, compiled._flat(self.fn(*self.static))):
            o.copy_(x)


@pytest.fixture
def cpu_capture(monkeypatch):
    """The renderer's programs captured on the CPU, through :class:`CpuGraph`."""
    from lens_flare_tpu_torch import compiled

    def graph(fn, static, pool):
        out = fn(*static)
        return CpuGraph(fn, static, compiled._flat(out)), out

    monkeypatch.setattr(compiled, "_captures", lambda x: True)
    monkeypatch.setattr(compiled, "_warm_up", lambda fn, static, dev: fn(*static))
    monkeypatch.setattr(compiled, "_new_pool", lambda: "pool")
    monkeypatch.setattr(compiled, "_graph", graph)


@pytest.mark.parametrize("name", CELLS)
def test_no_program_is_captured_in_the_window(tiny, monkeypatch, cpu_capture, name):
    """Set-up captures every program the traffic's frames replay: frames under new render seeds and
    new views capture none, and the adaptive stages pad to the widths the frames driver warms."""
    import lens_flare_tpu_torch.renderer as rmod

    from drivers.frames import chunk_widths

    grains, real_pad = [], rmod.pad_lanes

    def pad(px, py, tile, grain, multiple=1):
        grains.append((tile, grain))
        return real_pad(px, py, tile, grain, multiple)

    monkeypatch.setattr(rmod, "pad_lanes", pad)
    res, err = run_cpu(tiny(name), seconds=2.0)
    assert res["correct"], err
    assert "programs captured in the window 0" in err, err
    assert all(chunk_widths(tile)[0] == grain for tile, grain in grains)


def test_setup_captures_every_chunk_width(tiny, cpu_capture):
    """The adaptive cell's set-up captures the pixel-key and sample programs at every width a stage's
    last chunk can pad to, whichever widths its own frames took."""
    from drivers.frames import chunk_widths

    cell = tiny("config2_adaptive_1080p")
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 2**31 + 3, "cpu", Spans())
    drv.setup()
    captured = {(key[0], sig[0][0][0]) for key, sig in drv.r._programs._programs}
    tile = int(drv.r.tile_pixels)
    assert {(name, w) for name in ("keys", "sample") for w in chunk_widths(tile)} <= captured
    assert chunk_widths(65536) == [8192 * k for k in range(1, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """A short run of the cell at its own size on the card (``python -m pytest benchmark/tests -m gpu``)."""
    import subprocess
    import sys

    from conftest import BENCH

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", name, "--seed", "2147483911",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-4000:]
