"""The port's spans and counters: ``utils/profiling.py:span`` and ``Programs.replays``/``copies_in``.

Under ``torch.profiler`` a tiled and an adaptive ``Renderer.render``,
``composite_flare`` and a viewer ``Application.frame`` record their
``lf.*`` ranges, nested as the layers nest (a replay inside a tile inside
the render; the flare's tables and FFT inside its terms).  The frames run
through the compiled path on the CPU stand-in of the card
(``test_torch_compiled.cpu_capture``), so the replays show.  With no
profiler running a span makes one check and enters no range.  Each
``Programs`` counts its replays and the inputs they copy.
"""

import pytest
import torch
from test_torch_compiled import cpu_capture, terrain_file  # noqa: F401  (the card's stand-in; a flared terrain)
from torch.profiler import ProfilerActivity, profile

from lens_flare_tpu_torch import compiled
from lens_flare_tpu_torch.app import Application
from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(fn):
    """(fn's result, [(name, start, end)] of the lf.* ranges it opened) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("lf.")]
    return out, ranges


def named(ranges, name):
    return [(a, b) for n, a, b in ranges if n == f"lf.{name}"]


def nested(ranges, inner, outer) -> bool:
    """Every ``inner`` range lies inside some ``outer`` range."""
    outs = named(ranges, outer)
    return all(any(a0 <= a and b <= b0 for a0, b0 in outs) for a, b in named(ranges, inner))


def small_renderer(**kw):
    r = Renderer(device="cpu", width=16, height=12, tile_pixels=128, max_ray_depth=2, seed=0, **kw)
    r.load_flat_scene(make_terrain_scene(4))
    return r


# ---------------------------------------------------------------------------
# span
# ---------------------------------------------------------------------------


class Recorder:
    """Stands in for the profiler range: records the names it is entered with."""

    def __init__(self, names):
        self.names = names

    def __call__(self, name):
        self.names.append(name)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_without_a_profiler_checks_once_and_enters_no_range(monkeypatch):
    names, checks = [], []
    monkeypatch.setattr(profiling, "_Range", Recorder(names))
    monkeypatch.setattr(profiling, "_profiling", lambda: checks.append(1) or False)
    for _ in range(3):
        with profiling.span("renderer.tile"):
            pass
    assert names == [] and len(checks) == 3


def test_span_under_a_profiler_enters_its_range(monkeypatch):
    names = []
    monkeypatch.setattr(profiling, "_Range", Recorder(names))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("renderer.tile"):
            pass
    assert names == ["lf.renderer.tile"]


def test_span_is_a_profiler_range_on_the_kineto_clock():
    def work():
        with profiling.span("outer"):
            with profiling.span("inner"):
                return torch.ones(3) + 1

    _, ranges = traced(work)
    assert [n for n, _, _ in ranges] == ["lf.outer", "lf.inner"] and nested(ranges, "inner", "outer")


# ---------------------------------------------------------------------------
# the renderer, the flare and the viewer under a profiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["tiled", "adaptive"])
def test_render_records_its_spans_nested(mode, cpu_capture):
    kw = dict(ns_aa=4) if mode == "tiled" else dict(ns_aa=8, samples_per_batch=2)
    r, scene = traced(lambda: small_renderer(**kw))
    assert named(scene, "scene.build") and named(scene, "scene.upload")
    for rnd in range(2):  # the first render captures its programs, the second replays them
        _, ranges = traced(lambda: r.render(progress=False))
        assert len(named(ranges, "renderer.render")) == 1
        for inner in ("renderer.prepare", "renderer.tile", "renderer.stats"):
            assert named(ranges, inner) and nested(ranges, inner, "renderer.render"), inner
        assert nested(ranges, "compiled.replay", "renderer.tile")
        for inner in ("compiled.copy_in", "compiled.launch", "compiled.clone"):
            assert len(named(ranges, inner)) == len(named(ranges, "compiled.replay")) > 0
            assert nested(ranges, inner, "compiled.replay"), inner
        assert bool(named(ranges, "compiled.capture")) == (rnd == 0)
        assert nested(ranges, "compiled.capture", "renderer.tile")
        stages = len(r.stats.active_per_stage)
        assert len(named(ranges, "renderer.select")) == stages and (stages > 0) == (mode == "adaptive")
        assert nested(ranges, "renderer.select", "renderer.render")


def test_composite_flare_records_its_spans_nested(cpu_capture, terrain_file):  # noqa: F811
    r = Renderer(device="cpu", width=48, height=40, flare_intensity=1.5, flare_radius=30,
                 aperture=ApertureTexture.from_array(polygon_mask(32, 5)),
                 ghost_aperture_path=str(terrain_file.parent / "ghost.png"))
    r.load(terrain_file)
    hdr = torch.zeros((40, 48, 3))
    _, ranges = traced(lambda: r.composite_flare(hdr))
    for name in ("flare.build", "flare.ghosts", "flare.tables", "flare.starburst", "flare.fft", "flare.falloff"):
        assert len(named(ranges, name)) == 1, name
    assert nested(ranges, "flare.tables", "flare.ghosts") and nested(ranges, "compiled.replay", "flare.ghosts")
    assert nested(ranges, "flare.fft", "flare.starburst")
    (build,), (ghosts,) = named(ranges, "flare.build"), named(ranges, "flare.ghosts")
    assert build[1] <= ghosts[0]  # the pipeline is built before its terms


def test_viewer_frame_records_its_spans_nested(cpu_capture):
    app = Application(small_renderer(ns_aa=4), progressive_batch=1)
    app.keyboard_event("r")
    frame, ranges = traced(app.frame)
    assert frame.shape == (12, 16, 3)
    assert len(named(ranges, "renderer.render")) == 1
    for inner in ("renderer.prepare", "renderer.tile"):
        assert named(ranges, inner) and nested(ranges, inner, "renderer.render"), inner
    assert named(ranges, "app.scatter") and nested(ranges, "app.scatter", "renderer.tile")
    assert nested(ranges, "compiled.replay", "renderer.tile")
    (render,) = named(ranges, "renderer.render")
    for after in ("app.to_host", "image.to_color"):
        (span,) = named(ranges, after)
        assert span[0] >= render[1], after  # the copy and the tone map follow the progressive step


def test_sky_load_records_its_spans_and_builds_the_sky_once(tmp_path):
    """The command line's config-3 set-up: ``exr.read`` in ``lf.exr.read``, the COLLADA parse in
    ``lf.scene.parse`` inside ``Renderer.load``, the sky's tables in ``lf.env.build`` beside the tree's
    build; ``env_builds`` counts one build over any number of frames, none without a sky."""
    from lens_flare_tpu_torch.scene.writer import sky_map, terrain_dae
    from lens_flare_tpu_torch.utils import exr

    dae = terrain_dae(4).write(tmp_path / "t.dae")
    exr.write(tmp_path / "sky.exr", sky_map(32, 16), pixel_type=exr.PIXELTYPE_HALF)
    envmap, ranges = traced(lambda: exr.read(tmp_path / "sky.exr"))
    assert envmap.shape == (16, 32, 3) and len(named(ranges, "exr.read")) == 1
    r = Renderer(device="cpu", width=16, height=12, tile_pixels=128, max_ray_depth=2, envmap=envmap)
    _, ranges = traced(lambda: r.load(dae))
    for name in ("scene.parse", "env.build", "scene.build", "scene.upload"):
        assert len(named(ranges, name)) == 1, name
    (parse,), (build,) = named(ranges, "scene.parse"), named(ranges, "scene.build")
    assert parse[1] <= build[0]  # parsed, then built
    for _ in range(2):
        r.render(progress=False)
    assert r.env_builds == 1
    plain = Renderer(device="cpu", width=16, height=12, tile_pixels=128)
    plain.load(dae)
    assert plain.env_builds == 0


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------


def test_programs_count_replays_and_their_inputs(cpu_capture):
    programs = compiled.Programs()
    x = torch.arange(4.0)
    for _ in range(3):
        programs.run("two", lambda a, b: a + b, x, x)
    programs.run("one", lambda a: a * 2.0, x)
    # every call replays, the one that captures too
    assert (programs.replays, programs.copies_in) == (4, 7) and len(cpu_capture) == 2


def test_the_cpu_counts_no_replay():
    r = small_renderer(ns_aa=4)
    r.render(progress=False)
    assert (r._programs.replays, r._programs.copies_in) == (0, 0)


def test_a_frame_counts_its_replays_and_copies(cpu_capture):
    """12 x 16 pixels in two 128-lane tiles at 4 samples: per tile one keys replay (pixels and the key,
    3 inputs) and four sample replays (keys, sample index, pixels, valid and 8 camera fields, 13)."""
    r = small_renderer(ns_aa=4)
    for n in (1, 2):
        r.render(progress=False)
        assert (r._programs.replays, r._programs.copies_in) == (n * 10, n * (2 * 3 + 8 * 13))
