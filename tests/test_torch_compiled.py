"""Compiled frames: the captured programs of ``lens_flare_tpu_torch/compiled.py``.

On a CUDA device the Renderer replays captured CUDA graphs per sample of
a tile (``render_wavefront``) and of an adaptive chunk (``render_batch``),
and the flare pipeline one per ghost buffer.  The CPU runs the same functions
eagerly; these tests hold what the capture reshaped against the JAX
package, with the tolerances of ``tests/test_torch_integrator.py`` and
``tests/test_torch_thin_lens.py`` (>= 99% of lanes within 1e-4 absolute
plus 1e-4 relative, mean relative difference < 1e-3) and, for the ghost
buffers, those of ``tests/test_torch_realistic.py`` (1e-4 of the peak for
the exact splat, 1e-3 for the fast splat and the realistic stack):

- (a) ``render_batch`` with the sample offset as a 0-d tensor (as JAX
  traces it; a captured sample takes its index so) against JAX's at the
  same offset, and bit-equal to the port's int-offset call;
- (b) the adaptive render, whose ragged chunks are padded with
  ``valid=False`` lanes to the JAX package's buckets, against the JAX
  ``Renderer``'s: film, counts, rays traced, NEE lanes skipped and the
  pixels left after each stage;
- (c) both ghost buffers with their static tables made ahead against
  JAX's, and bit-equal to the tables made in the call;
- (d) the launch bookkeeping: a capture records each kernel's launches
  once, and every replay adds them;
- (e) ``compiled.disabled()`` nests, and the CPU builds no program.

A stand-in for the card (``cpu_capture``) runs the whole compiled path on
the CPU: ``Programs`` captures through a "graph" that re-runs the function
on its static inputs, under a dispatch mode that fails on every op a CUDA
graph capture refuses or would bake in from the host (a tensor made from
host data, a read of a value back to the host, a boolean-mask index), the
kernels' plain versions excepted.  Frames of every route (A and C, D and
B, G), the sky, the thin-lens bokeh and the Cornell box's lights, tiled
and adaptive, then equal the eager frames bit for bit, launch counts
included (counted on the CPU by a wrapper of the kernel dispatch).

On the card (``-m gpu``): replayed frames through A and C, D and B, and G,
with and without the sky, tiled and adaptive, equal ``compiled.disabled()``
frames bit for bit (film, counts, rays, tests, skipped) with the same
launch counts; the ghost buffers equal the eager ones bit for bit (the
realistic one sums its taps in a fixed order, ``realistic.ordered_sum``),
and within ``flare.moments.GHOST_F32`` per channel (energy, centroid,
radius).

Captured optimisation steps (``compiled.Step``, config 5):
``recover_emitter`` on the Cornell box (A and C), ``optimize_lens`` (plain,
and checkpointed then resumed) and ``make_train_step`` (without a mesh and
on two stand-in shards) give, step for step, the losses, parameters and
launch counts of ``compiled.disabled()`` runs bit for bit: on the CPU
stand-in, which follows the card's protocol (step 1 the warm-up, step 2
the capture, one run of the step per call), and on the card
(``-m gpu``), where both sides use ``Adam(capturable=True)``.
"""

import gc
import tempfile
import weakref

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu.flare.pipeline import FlarePipeline as JaxPipeline
    from lens_flare_tpu.integrator import path as jpath
    from lens_flare_tpu.renderer import Renderer as JaxRenderer
    from lens_flare_tpu.scene.procedural import make_terrain_scene as j_make_terrain_scene
except ImportError:  # the card's machine: only the gpu cases can run
    jax = None

from lens_flare_tpu_torch import _rng, compiled
from lens_flare_tpu_torch import renderer as rmod
from lens_flare_tpu_torch.convert import camera_params_from_numpy
from lens_flare_tpu_torch.flare.moments import GHOST_F32, buffer_moments, ghost_errors
from lens_flare_tpu_torch.integrator import path as tpath
from lens_flare_tpu_torch.lens import paraxial, realistic
from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.scene.writer import cornell_box, sky_map, terrain_dae

W, H = 40, 30
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of lanes within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


def _close_to_peak(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.abs(want).max() > 0
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


# ---------------------------------------------------------------------------
# (a), (b), (c): the reshaped eager path against the JAX package
# ---------------------------------------------------------------------------


@needs_jax
def test_render_batch_offset_tensor_matches_jax():
    """Samples 3-4 of every pixel of terrain 8 (kernels A and C) with the offset as a 0-d tensor."""
    kw = dict(width=W, height=H, ns_aa=2, max_ray_depth=4, ns_area_light=1, indirect=True, seed=0)
    jr = JaxRenderer(use_pallas=False, **kw)
    jr.load_flat_scene(j_make_terrain_scene(8))
    r = Renderer(device="cpu", **kw)
    r.load_flat_scene(make_terrain_scene(8))
    i = np.arange(W * H)
    px, py = (i % W).astype(np.int32), (i // W).astype(np.int32)
    valid = i < W * H - 37  # a padded tail, as a bucket has
    want = jpath.render_batch(
        jr.bundle, jr.settings, jr.camera.params(), jnp.asarray(px), jnp.asarray(py), W, H,
        jax.random.PRNGKey(0), jnp.uint32(3), 2, jnp.asarray(valid),
    )
    cam = camera_params_from_numpy(jr.camera.params())
    args = (r.bundle, r.settings, cam, torch.as_tensor(px), torch.as_tensor(py), W, H, _rng.prng_key(0))
    got = tpath.render_batch(*args, torch.tensor(3), 2, valid=torch.as_tensor(valid))
    by_int = tpath.render_batch(*args, 3, 2, valid=torch.as_tensor(valid))
    for g, b in zip(got, by_int):
        assert torch.equal(g, b)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w))
    # rays traced and NEE lanes skipped; primitive tests count another tree's walk (JAX's XLA BVH)
    assert got[3][0] > 0 and got[3][2] > 0
    np.testing.assert_array_equal(got[3].numpy()[[0, 2]], np.asarray(want[3])[[0, 2]])


@needs_jax
def test_adaptive_buckets_match_jax(monkeypatch):
    """Terrain 8's adaptive render in 512-lane chunks: ragged chunks padded to 256-lane buckets, as JAX's."""
    kw = dict(width=W, height=H, ns_aa=16, samples_per_batch=2, max_tolerance=0.05, max_ray_depth=4,
              ns_area_light=1, indirect=True, seed=0, tile_pixels=512)
    jr = JaxRenderer(use_pallas=False, **kw)
    jr.load_flat_scene(j_make_terrain_scene(8))
    want, want_counts = jr.render(progress=False)
    r = Renderer(device="cpu", **kw)
    r.load_flat_scene(make_terrain_scene(8))
    widths, orig = [], rmod.render_batch

    def spy(bundle, settings, cam, px, py, *args, **kw):
        widths.append((px.shape[0], int(kw["valid"].sum())))
        return orig(bundle, settings, cam, px, py, *args, **kw)

    monkeypatch.setattr(rmod, "render_batch", spy)
    got, counts = r.render(progress=False)
    # 1,200 pixels: chunks of 512, 512 and 176 (padded to 256), then the survivors
    assert widths[:3] == [(512, 512), (512, 512), (256, 176)]
    assert all(w in (256, 512) and w - m < 256 for w, m in widths)
    jc = np.asarray(want_counts)
    np.testing.assert_array_equal(counts.numpy(), jc)
    _close(got.numpy().reshape(-1, 3), np.asarray(want).reshape(-1, 3))
    # stages of 2, 2, 4 and 8 samples: the pixels left after the first three, from JAX's counts
    assert r.stats.active_per_stage[:3] == [int((jc > n).sum()) for n in (2, 4, 8)]
    assert r.stats.active_per_stage[1] > 0
    assert r.stats.total_rays == jr.stats.total_rays
    assert r.stats.total_zero_skipped == jr.stats.total_zero_skipped > 0


@pytest.fixture(scope="module")
def terrain_file(tmp_path_factory):
    """Terrain 8's COLLADA file, whose sun is on screen, and a ghost texture beside it."""
    from lens_flare_tpu_torch.utils.image import save_png

    d = tmp_path_factory.mktemp("compiled")
    save_png(d / "ghost.png", polygon_mask(16, 6))
    return terrain_dae(8).write(d / "terrain.dae")


def _flare_kw(case, terrain_file):
    if case == "realistic":
        return dict(lens_model="realistic")
    return dict(ghost_aperture_path=str(terrain_file.parent / "ghost.png"))


@needs_jax
@pytest.mark.parametrize("case", ["realistic", "paraxial_exact", "paraxial_fast"])
def test_ghost_buffers_with_tables_made_ahead(case, terrain_file):
    """The pipeline's ghost buffer (its tables made once, before the call) against JAX's, twice."""
    w, h = 48, 40
    kw = _flare_kw(case, terrain_file)
    r = Renderer(device="cpu", width=w, height=h, **kw)
    r.load(terrain_file)
    j = JaxRenderer(width=w, height=h, use_pallas=False, **kw)
    j.load(terrain_file)
    p, jp = r.flare_pipeline(), JaxPipeline.from_renderer(j)
    assert p.programs is r._flare_programs
    if case != "realistic":
        p.ghost_method = jp.ghost_method = case.removeprefix("paraxial_")
    pairs, tables = p._ghost_tables  # made once per pipeline
    got = p.ghost_buffer()
    assert torch.equal(p.ghost_buffer(), got) and p._ghost_tables[1] is tables
    assert got.shape == (h, w, 3) and got.sum() > 0
    _close_to_peak(got.numpy(), np.asarray(jp.ghost_buffer()), 1e-4 if case == "paraxial_exact" else 1e-3)
    # the tables made in the call give the same buffer, bit for bit
    angle = torch.tensor(p.angle_to_sun, dtype=torch.float32)
    axis = torch.as_tensor(p.axis_ray, dtype=torch.float32)
    if case == "realistic":
        rad = torch.as_tensor(p.flare_radiances.sum(axis=0))
        assert torch.equal(realistic.render_ghosts_stack(p.lens, angle, rad, axis, w, h), got)
    else:
        r1, r2 = paraxial.trace_all_ghosts(p.lens, angle)
        s1, s2 = paraxial.trace_all_ghosts(p.lens, angle, pairs)
        assert torch.equal(r1, s1) and torch.equal(r2, s2)
    assert len(r._flare_programs) == 0  # the CPU captures nothing


# ---------------------------------------------------------------------------
# (d), (e): bookkeeping and the switch
# ---------------------------------------------------------------------------


class CpuGraph:
    """Stands in for a CUDA graph: a replay re-runs the captured function into its static outputs.

    On the card a capture records without running, and the first replay
    runs what it recorded.  The stand-in's capture ran the function on the
    static inputs, which the first replay copies in again unchanged, so that
    replay has nothing left to run: each call runs the function as often as
    on the card (a training step, which updates its state, once).  The
    re-run's own launch counts are taken back, as a graph's replay runs no wrapper.
    """

    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        if self.replays == 1:
            return  # the capture ran it
        counts = compiled.launch_counts()
        with NoHostSync():
            out = self.fn(*self.static)
        for k, n in counts.items():
            ic.KERNELS[k].launches = n
        for o, n in zip(self.outputs, compiled._flat(out)):
            o.copy_(n)


class NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on ops that a CUDA graph capture refuses or bakes in: tensors made from host data
    (``lift_fresh``: ``torch.tensor``, ``as_tensor`` of a list or array, list indices), reads back
    to the host (``.item()``, ``int()``, ``bool()``), ``nonzero`` and boolean-mask indexing.
    ``paused`` lets the kernels' plain versions (which the card does not run) through."""

    BANNED = ("lift_fresh", "_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal", "unique",
              "repeat_interleave")
    paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not NoHostSync.paused:
            name = func.overloadpacket.__name__
            assert not name.startswith(self.BANNED), f"{func} in a captured program"
            if name in ("index", "index_put", "index_put_"):
                idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
                assert not any(t is not None and t.dtype == torch.bool for t in idx), f"boolean index: {func}"
        return func(*args, **kwargs)


def _paused(call):
    """``call`` with :class:`NoHostSync` off: what the card runs otherwise, or is built to capture."""

    def run(*args, **kw):
        NoHostSync.paused += 1
        try:
            return call(*args, **kw)
        finally:
            NoHostSync.paused -= 1

    return run


@pytest.fixture
def cpu_capture(monkeypatch):
    """The compiled path on the CPU: ``Programs`` captures through :class:`CpuGraph`, and the kernel
    wrappers count their (plain-version) launches.  Yields the list of graphs made.

    ``torch.optim.Adam.step`` runs with :class:`NoHostSync` off: the card's
    Adam keeps its step count on the device (``capturable=True``), which the
    CPU's cannot, and reads it on the host."""
    graphs = []

    def graph(fn, static, pool):
        with NoHostSync():
            out = fn(*static)
        g = CpuGraph(fn, static, compiled._flat(out))
        graphs.append(g)
        return g, out

    monkeypatch.setattr(compiled, "_captures", lambda x: True)
    monkeypatch.setattr(compiled, "_warm_up", lambda fn, static, dev: fn(*static))
    monkeypatch.setattr(compiled, "_new_pool", lambda: "pool")
    monkeypatch.setattr(compiled, "_graph", graph)
    monkeypatch.setattr(torch.optim.Adam, "step", _paused(torch.optim.Adam.step))
    dispatch, walk = ic._dispatch, tpath.bvh_walk

    def counted(key, call):
        def run(*args, **kw):
            ic.KERNELS[key if isinstance(key, str) else key(args)].launches += 1
            return _paused(call)(*args, **kw)
        return run

    monkeypatch.setattr(ic, "_dispatch", counted(lambda a: a[0], dispatch))
    monkeypatch.setattr(tpath, "bvh_walk", counted("G", walk))
    yield graphs


def _stub(calls, bumps):
    """A program that doubles its input and bumps ``KERNELS`` as its wrappers would."""

    def fn(x):
        calls.append(1)
        for k, n in bumps.items():
            ic.KERNELS[k].launches += n
        return x * 2.0, x.sum(dtype=torch.float64)

    return fn


def test_launches_recorded_once_and_added_per_replay(cpu_capture):
    ic.reset_launch_counts()
    programs, calls = compiled.Programs(), []
    fn = _stub(calls, {"A": 2, "G": 1})
    x = torch.arange(6.0)
    out, total = programs.run("k", fn, x)
    # the warm-up and the capture ran the function (the first replay runs what the capture did, as on
    # the card); the counts are one call's
    assert len(calls) == 2 and len(cpu_capture) == 1 and cpu_capture[0].replays == 1
    assert compiled.launch_counts() == {**{k: 0 for k in "ABCDEF"}, "A": 2, "G": 1}
    assert torch.equal(out, x * 2.0) and total.item() == 15.0
    out2, _ = programs.run("k", fn, x + 1.0)
    assert len(calls) == 3 and len(programs) == 1 and cpu_capture[0].replays == 2
    assert torch.equal(out2, (x + 1.0) * 2.0) and torch.equal(out, x * 2.0)  # a replay's outputs are new tensors
    assert compiled.launch_counts()["A"] == 4 and compiled.launch_counts()["G"] == 2
    programs.run("k", fn, torch.arange(4.0))  # another shape: another program
    assert len(programs) == 2 and compiled.launch_counts()["A"] == 6
    programs.clear()
    programs.run("k", fn, x)  # captured again, its counts still one call's
    assert len(programs) == 1 and len(cpu_capture) == 3 and compiled.launch_counts()["A"] == 8


def test_failed_capture_leaves_counts_and_cache(cpu_capture):
    ic.reset_launch_counts()
    programs = compiled.Programs()

    def broken(x):
        ic.KERNELS["B"].launches += 1
        return x[x > 0]  # a boolean mask: refused inside a capture

    with pytest.raises(AssertionError, match="boolean index"):
        programs.run("k", broken, torch.arange(3.0))
    assert len(programs) == 0 and compiled.launch_counts()["B"] == 0


def test_step_runs_once_per_call(cpu_capture):
    """A ``compiled.Step``: the first call is the warm-up and a step of its own, the second captures and
    replays, later ones replay; the function runs once per call, so the state moves one step per call."""
    ic.reset_launch_counts()
    state, calls = torch.zeros(()), []

    def fn(x):
        calls.append(1)
        ic.KERNELS["C"].launches += 3
        state.add_(x.sum())
        return state * 1.0

    step = compiled.Step(fn, state)
    outs = [step(torch.ones(())).item() for _ in range(4)]
    assert outs == [1.0, 2.0, 3.0, 4.0] and len(calls) == 4 and state.item() == 4.0
    assert len(step.programs) == 1 and len(cpu_capture) == 1 and cpu_capture[0].replays == 3
    assert compiled.launch_counts()["C"] == 12  # the warm-up's, then the capture's added per replay
    assert step.programs.capture_s > 0
    step(torch.ones(2))  # another input shape: a warm-up of its own, no capture yet
    assert len(step.programs) == 1 and len(calls) == 5
    with compiled.disabled():
        step(torch.ones(()))
    assert len(calls) == 6 and len(cpu_capture) == 1


def test_disabled_nests(cpu_capture):
    programs, calls = compiled.Programs(), []
    fn = _stub(calls, {})
    with compiled.disabled():
        programs.run("k", fn, torch.ones(2))
        with compiled.disabled():
            programs.run("k", fn, torch.ones(2))
        programs.run("k", fn, torch.ones(2))  # still inside the outer block
    assert len(calls) == 3 and len(programs) == 0 and not cpu_capture
    programs.run("k", fn, torch.ones(2))
    assert len(programs) == 1 and len(cpu_capture) == 1


def test_the_cpu_builds_no_program():
    r = Renderer(device="cpu", width=16, height=12, tile_pixels=64, ns_aa=4, samples_per_batch=2)
    r.load_flat_scene(make_terrain_scene(4))
    r.render(progress=False)
    assert len(r._programs) == 0 and r._programs.capture_s == 0.0


# ---------------------------------------------------------------------------
# the whole compiled path on the CPU stand-in, against eager frames
# ---------------------------------------------------------------------------

FRAMES = {
    # kernel route, sizes: 40 x 30 pixels in 512-lane tiles (the last one padded)
    "terrain8_A_C": dict(scene=8),
    "terrain40_D_B_adaptive": dict(scene=40, ns_aa=8, samples_per_batch=2),
    "terrain40_G": dict(scene=40, use_wide_tree=False),
    "terrain8_sky_adaptive": dict(scene=8, sky=True, ns_aa=8, samples_per_batch=2),
    "terrain40_bokeh_adaptive": dict(scene=40, bokeh=True, ns_aa=8, samples_per_batch=2),
    "cornell_hemisphere": dict(scene="cornell", direct_hemisphere_sample=True),
    "cornell_lights": dict(scene="cornell", max_ray_depth=5),
}


def frame_renderer(case, device, tmp_path, width=W, height=H, tile=512):
    kw = dict(FRAMES[case])
    scene = kw.pop("scene")
    if kw.pop("sky", False):
        kw["envmap"] = sky_map(64, 32)
    if kw.pop("bokeh", False):
        kw.update(lens_radius=0.05, focal_distance=1.5, bokeh=ApertureTexture.from_array(polygon_mask(32, 8)))
    kw.setdefault("max_ray_depth", 4)
    r = Renderer(device=device, width=width, height=height, seed=0, tile_pixels=tile, **kw)
    if scene == "cornell":
        r.load(cornell_box().write(tmp_path / "cornell.dae"))
    else:
        r.load_flat_scene(make_terrain_scene(scene))
    return r


def _render(r):
    ic.reset_launch_counts()
    hdr, counts = r.render(progress=False)
    st = r.stats
    return hdr, counts, (st.total_rays, st.total_isects, st.total_zero_skipped, list(st.active_per_stage)), \
        compiled.launch_counts()


@pytest.mark.parametrize("case", list(FRAMES))
def test_compiled_frame_equals_eager_on_the_cpu_stand_in(case, cpu_capture, tmp_path):
    r = frame_renderer(case, "cpu", tmp_path)
    with compiled.disabled():
        want = _render(r)
    got = _render(r)
    assert len(r._programs) >= 1 and len(cpu_capture) == len(r._programs)
    again = _render(r)  # every program replayed, none captured again
    assert len(cpu_capture) == len(r._programs)
    for a, b in ((got, want), (again, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[2] == b[2] and a[3] == b[3], (a[2:], b[2:])
    assert sum(want[3].values()) > 0 and want[2][0] > 0


def test_one_sample_program_replayed_per_sample(cpu_capture):
    """A 4-sample frame in two tiles captures the pixel keys and one sample once, and replays the
    keys per tile and the sample per tile and sample index."""
    r = Renderer(device="cpu", width=16, height=12, tile_pixels=128, ns_aa=4, max_ray_depth=2, seed=0)
    r.load_flat_scene(make_terrain_scene(4))
    with compiled.disabled():
        want = _render(r)
    got = _render(r)
    keys, sample = cpu_capture
    assert len(r._programs) == 2 and (keys.replays, sample.replays) == (2, 8)
    assert torch.equal(got[0], want[0]) and got[2:] == want[2:]


@pytest.mark.parametrize("case", ["realistic", "paraxial_exact", "paraxial_fast"])
def test_compiled_ghost_buffer_equals_eager_on_the_cpu_stand_in(case, cpu_capture, terrain_file):
    r = Renderer(device="cpu", width=48, height=40, **_flare_kw(case, terrain_file))
    r.load(terrain_file)
    p = r.flare_pipeline()
    if case != "realistic":
        p.ghost_method = case.removeprefix("paraxial_")
    with compiled.disabled():
        want = p.ghost_buffer()
    got = p.ghost_buffer()
    assert len(r._flare_programs) == 1 and torch.equal(got, want)
    # a new pipeline of the same renderer replays the same program
    p2 = r.flare_pipeline()
    p2.ghost_method = p.ghost_method
    assert torch.equal(p2.ghost_buffer(), want) and len(cpu_capture) == 1


def test_a_dropped_renderer_frees_its_programs_at_once(cpu_capture, terrain_file):
    """No program holds its owner: a renderer and its graphs go with their last reference, not later
    through the cyclic collector, which could destroy a graph inside another program's capture."""
    r = Renderer(device="cpu", width=48, height=40, tile_pixels=1024, lens_model="realistic")
    r.load(terrain_file)
    r.render(progress=False)
    r.flare_pipeline().ghost_buffer()
    assert len(r._programs) == 2 and len(r._flare_programs) == 1  # two tiles of one keys and one sample program
    owner, graphs = weakref.ref(r), [weakref.ref(g) for g in cpu_capture]
    cpu_capture.clear()
    enabled = gc.isenabled()
    gc.disable()
    try:
        del r
        assert owner() is None and all(g() is None for g in graphs)
    finally:
        if enabled:
            gc.enable()


# ---------------------------------------------------------------------------
# captured optimisation steps (config 5) against compiled.disabled()
# ---------------------------------------------------------------------------

# recover_emitter on the Cornell box (kernels A and C), optimize_lens from a perturbed curvature (plain,
# and 3 steps checkpointed then resumed to 6), and make_train_step without a mesh and on two stand-in
# shards of one device: (case, programs captured)
STEPS = {"recover_emitter": 1, "optimize_lens": 1, "optimize_lens_resumed": 2, "train_step": 1,
         "train_step_stand_ins": 1}
SW, SH = 24, 18  # the render's film; the lens design's is 32 x 32


@pytest.fixture(scope="module")
def cornell_file(tmp_path_factory):
    return cornell_box().write(tmp_path_factory.mktemp("steps") / "cornell.dae")


def run_steps(case, device, cornell, tmp_path):
    """(losses, parameters on the CPU, launches of A-G) of a few steps of ``case`` on ``device``."""
    import chip_smoke
    from lens_flare_tpu_torch.diff import render as dr
    from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS, OptimizeConfig, ghost_image, optimize_lens
    from lens_flare_tpu_torch.lens.prescription import reference_prescription
    from lens_flare_tpu_torch.parallel import render as prender
    from lens_flare_tpu_torch.parallel.mesh import make_mesh

    ic.reset_launch_counts()
    if case == "recover_emitter":
        c = chip_smoke.diff_case(cornell, device, SW, SH, 2, 2, aim=True)
        rows = chip_smoke.emitter_params(c.r.scene)
        er, lr = rows["emitter"][2], rows["light"][2]
        target = chip_smoke.diff_render(c, dr.set_emitter_color(c.bundle, er, lr, (0.9, 0.55, 0.2)))
        ic.reset_launch_counts()
        color, losses = dr.recover_emitter(c.bundle, c.settings, c.cam, c.px, c.py, SW, SH, target, er, lr,
                                           init_color=(2.0, 2.0, 2.0), n_samples=2, steps=5, learning_rate=0.2,
                                           key=c.key)
        return losses, [color.cpu()], compiled.launch_counts()
    tex = torch.as_tensor(polygon_mask(32, 6), device=device)
    axis = torch.tensor([0.6, 0.55], device=device)
    target = ghost_image(reference_prescription(device=device), tex, axis, 0.35, 32, 32).detach()
    lens0 = reference_prescription(device=device)
    lens0.curvatures = lens0.curvatures * torch.tensor([1.03] + [1.0] * 9, device=device)
    if case.startswith("optimize_lens"):
        run = dict(init_lens=lens0, device=device)
        if case == "optimize_lens":
            lens, losses = optimize_lens(target, tex, axis, 0.35, OptimizeConfig(steps=6, log_every=0), **run)
        else:
            ck = tempfile.mkdtemp(dir=tmp_path)  # a run of its own: no checkpoint of an earlier run
            cfg = dict(log_every=0, checkpoint_dir=str(ck), checkpoint_every=2)
            _, losses = optimize_lens(target, tex, axis, 0.35, OptimizeConfig(steps=3, **cfg), **run)
            lens, rest = optimize_lens(target, tex, axis, 0.35, OptimizeConfig(steps=6, **cfg), **run)
            assert len(losses) == len(rest) == 3
            losses += rest
    else:
        mesh = make_mesh(devices=[device] * 2) if case == "train_step_stand_ins" else None
        lens, step = prender.make_train_step(lens0, tex, axis, 0.35, 32, 32, mesh=mesh)
        losses = [step(target).item() for _ in range(5)]
    return losses, [getattr(lens, f).detach().cpu() for f in LENS_FIELDS], compiled.launch_counts()


def _same_steps(got, want):
    assert got[0] == want[0], (got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2], (got[2], want[2])


@pytest.mark.parametrize("case", list(STEPS))
def test_captured_step_equals_eager_on_the_cpu_stand_in(case, cpu_capture, cornell_file, tmp_path):
    """Each step, the warm-up (step 1) and the resumed run's first included, gives the losses and
    parameters of ``compiled.disabled()`` bit for bit, with the same launch counts: no step is run
    twice or skipped, and nothing in a step's body syncs with the host."""
    with compiled.disabled():
        want = run_steps(case, "cpu", cornell_file, tmp_path)
    assert not cpu_capture
    got = run_steps(case, "cpu", cornell_file, tmp_path)
    _same_steps(got, want)
    assert len(cpu_capture) == STEPS[case]
    assert sum(g.replays for g in cpu_capture) == len(want[0]) - STEPS[case]  # every step after each warm-up
    assert len(set(want[0])) == len(want[0])  # every step moved the parameters
    if case == "recover_emitter":
        assert want[2]["A"] > 0 and want[2]["C"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FRAMES))
def test_replay_equals_eager_on_card(case, cuda_device, tmp_path):
    r = frame_renderer(case, "cuda", tmp_path, width=96, height=72, tile=2048)
    with compiled.disabled():
        want = _render(r)
    got = _render(r)
    again = _render(r)
    assert len(r._programs) >= 1
    for a in (got, again):
        assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
        assert a[2] == want[2] and a[3] == want[3], (a[2:], want[2:])
    assert sum(want[3].values()) > 0


@pytest.mark.gpu
def test_capture_after_a_dropped_renderer_on_card(cuda_device, tmp_path):
    """A renderer dropped after its replays, then another one capturing the same frame (as the
    command line and a Renderer in one process do)."""
    first = frame_renderer("terrain8_A_C", "cuda", tmp_path, width=96, height=72, tile=2048)
    want = _render(first)
    del first
    second = frame_renderer("terrain8_A_C", "cuda", tmp_path, width=96, height=72, tile=2048)
    got = _render(second)
    assert torch.equal(got[0], want[0]) and got[2:] == want[2:]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["realistic", "paraxial_exact", "paraxial_fast"])
def test_replayed_ghost_buffer_on_card(case, cuda_device, terrain_file):
    r = Renderer(device="cuda", width=96, height=72, **_flare_kw(case, terrain_file))
    r.load(terrain_file)
    p = r.flare_pipeline()
    if case != "realistic":
        p.ghost_method = case.removeprefix("paraxial_")
    with compiled.disabled():
        want = p.ghost_buffer()
    got, again = p.ghost_buffer(), p.ghost_buffer()
    assert len(r._flare_programs) == 1
    assert torch.equal(got, want) and torch.equal(again, want)
    for buf in (got, again):
        errs = ghost_errors(buffer_moments(buf, p.axis_ray), buffer_moments(want, p.axis_ray))
        for measure, limit in GHOST_F32.items():
            assert max(errs[measure].values()) <= limit, (measure, errs[measure])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(STEPS))
def test_captured_step_equals_eager_on_card(case, cuda_device, cornell_file, tmp_path):
    """Captured steps against ``compiled.disabled()`` ones, both with ``Adam(capturable=True)``: bit for
    bit where two eager runs are (recover_emitter's backward adds through ``embedding``'s segmented
    sums), else within 1e-4 relative, with the eager runs' own spread printed beside it."""
    with compiled.disabled():
        want = run_steps(case, "cuda", cornell_file, tmp_path)
        again = run_steps(case, "cuda", cornell_file, tmp_path)
    got = run_steps(case, "cuda", cornell_file, tmp_path)
    assert got[2] == want[2]
    eager_equal = again[0] == want[0] and all(torch.equal(a, b) for a, b in zip(again[1], want[1]))
    spread = max(abs(a - b) / abs(b) for a, b in zip(again[0], want[0]))
    print(f"[step_on_card:{case}] eager_runs_bit_equal={eager_equal} eager_spread={spread:.3g} "
          f"captured_bit_equal={got[0] == want[0]}")
    if eager_equal or case != "recover_emitter":
        _same_steps(got, want)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4)
