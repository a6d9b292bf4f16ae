"""The renderer's held pixel lanes: ``Renderer.render`` orders and uploads a film's lanes once.

The first render of a film (or a cell of it) puts its pixel coordinates on
the device in 32x32 block order (``blocked_order``); later renders of the
same cell, film width and device take the held tensors.  The viewer's
batch (``Renderer.add_samples``) holds its cell's lanes in row-major order
in a slot of its own.  A renderer that renders twice, the camera moved and
the seed changed in between, gives each time the film and counts of a
fresh renderer, bit for bit, on the tiled, the adaptive and the
progressive path.  ``lanes_built`` and ``lanes_reused`` count the two
cases; another cell or width builds anew, also when the width is assigned
directly.  No path writes into the held lanes.  The renders run eagerly,
through the replayed programs on the CPU stand-in of the card
(``test_torch_compiled.cpu_capture``), and on the card (``-m gpu``).
"""

import numpy as np
import pytest
import torch
from test_torch_compiled import cpu_capture  # noqa: F401  (the card's stand-in)

from lens_flare_tpu_torch.renderer import Renderer, blocked_order
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

MODES = {
    "tiled": dict(ns_aa=1),
    # stages of 2, 2 and 4 samples, the active set repacked between them
    "adaptive": dict(ns_aa=8, samples_per_batch=2, max_tolerance=0.05),
    # the viewer's frame: samples 1 and 2 of each pixel added to a film (Renderer.add_samples)
    "progressive": dict(ns_aa=4),
}
KINDS = {"tiled": "blocked", "adaptive": "blocked", "progressive": "rows"}  # the held lanes each mode takes
CELLS = {"whole": None, "cell": (10, 6, 70, 60)}
FRAMES = ((0.0, 3), (0.2, 2_648_000_017))  # (theta step from the placed camera, render seed)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def terrain():
    return make_terrain_scene(4)


def make(terrain, mode, device="cpu", width=96, height=80):
    """A 96x80 film in wavefronts of 2,048 lanes: 4 tiles whole, 3 for the cell."""
    r = Renderer(width=width, height=height, max_ray_depth=2, tile_pixels=2048, device=device, **MODES[mode])
    r.load_flat_scene(terrain)
    return r


def frame(r, mode, theta0, step, seed, cell):
    r.camera.theta = theta0 + step
    r.camera.compute_position()
    r.seed = seed
    if mode != "progressive":
        return r.render(cell=cell, progress=False)
    film = torch.zeros((r.height, r.width, 3), device=r.device)
    counts = torch.zeros((r.height, r.width), dtype=torch.int32, device=r.device)
    r.add_samples(film, counts, (0, 0, r.width, r.height) if cell is None else cell, 1, 2)
    return film, counts


def expected_lanes(cell, width, height, kind="blocked"):
    x0, y0, dx, dy = (0, 0, width, height) if cell is None else cell
    ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
    xs, ys = xs.ravel(), ys.ravel()
    order = blocked_order(xs, ys, width) if kind == "blocked" else np.arange(xs.shape[0])
    return xs[order], ys[order]


def renders_as_fresh(terrain, mode, cell, device):
    """Two frames of one renderer against a fresh renderer's each; returns the held renderer."""
    r = make(terrain, mode, device)
    theta0 = r.camera.theta
    for step, seed in FRAMES:
        film, counts = frame(r, mode, theta0, step, seed, cell)
        want_film, want_counts = frame(make(terrain, mode, device), mode, theta0, step, seed, cell)
        assert torch.equal(film, want_film) and torch.equal(counts, want_counts)
        assert int(counts.sum()) > 0
    assert (r.lanes_built, r.lanes_reused) == (1, 1)
    assert list(r._lanes) == [KINDS[mode]]
    xs, ys = r._lanes[KINDS[mode]][1:]
    want_xs, want_ys = expected_lanes(cell, 96, 80, KINDS[mode])
    assert np.array_equal(xs.cpu().numpy(), want_xs) and np.array_equal(ys.cpu().numpy(), want_ys)
    return r


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("mode", list(MODES))
def test_second_render_equals_a_fresh_renderer(terrain, mode, cell):
    renders_as_fresh(terrain, mode, CELLS[cell], "cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_second_render_equals_a_fresh_renderer_replayed(terrain, mode, cpu_capture):  # noqa: F811
    r = renders_as_fresh(terrain, mode, None, "cpu")
    assert r._programs.replays > 0 and cpu_capture


def test_counters_build_once_per_cell_and_width(terrain):
    r = make(terrain, "tiled", width=24, height=20)
    a, b = (2, 3, 10, 8), (2, 3, 12, 9)  # b: the same corner, another size

    def counts(*cells):
        seen = []
        for cell in cells:
            r.render(cell=cell, progress=False)
            seen.append((r.lanes_built, r.lanes_reused))
        return seen

    assert counts(None, None, a, a, b, b) == [(1, 0), (1, 1), (2, 1), (2, 2), (3, 2), (3, 3)]
    r.width = 20  # assigned directly: set_frame_size is not what drops the lanes
    assert counts(b, b) == [(4, 3), (4, 4)]
    want_xs, want_ys = expected_lanes(b, 20, 20)
    xs, ys = r._lanes["blocked"][1:]
    assert np.array_equal(xs.numpy(), want_xs) and np.array_equal(ys.numpy(), want_ys)
    r.set_frame_size(24, 20)
    assert counts(None, None) == [(5, 4), (5, 5)]


@pytest.mark.parametrize("cell", list(CELLS))
def test_held_lanes_are_blocked_order_and_unchanged_by_both_paths(terrain, cell):
    cell = CELLS[cell]
    r = make(terrain, "tiled")
    r.render(cell=cell, progress=False)
    key, xs, ys = r._lanes["blocked"]
    versions = (xs._version, ys._version)
    for kw in MODES["adaptive"], MODES["tiled"]:  # the adaptive path, then the tiled path again
        for k, v in kw.items():
            setattr(r, k, v)
        r.update_settings()
        r.render(cell=cell, progress=False)
        assert r._lanes["blocked"][0] == key and r._lanes["blocked"][1] is xs and r._lanes["blocked"][2] is ys
    assert r.stats.active_per_stage  # the adaptive path ran
    assert (r.lanes_built, r.lanes_reused) == (1, 2)
    assert (xs._version, ys._version) == versions  # no in-place write
    assert xs.dtype == ys.dtype == torch.int64
    want_xs, want_ys = expected_lanes(cell, 96, 80)
    assert np.array_equal(xs.numpy(), want_xs) and np.array_equal(ys.numpy(), want_ys)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("mode", list(MODES))
def test_second_render_equals_a_fresh_renderer_on_card(terrain, mode, cell, cuda_device):
    r = renders_as_fresh(terrain, mode, CELLS[cell], "cuda")
    assert r._programs.replays > 0  # the frames went through the replayed programs
    xs, ys = r._lanes[KINDS[mode]][1:]
    want_xs, want_ys = expected_lanes(CELLS[cell], 96, 80, KINDS[mode])
    assert xs.is_cuda and np.array_equal(xs.cpu().numpy(), want_xs) and np.array_equal(ys.cpu().numpy(), want_ys)
