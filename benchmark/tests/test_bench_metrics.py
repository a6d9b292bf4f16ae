"""The trace reduction and the per-layer readers on a synthetic trace; the corrected roofline bound."""

import numpy as np
import pytest
import torch
from conftest import BENCH  # noqa: F401  (puts benchlib on the path)

from benchlib import manifest, roofline
from benchlib.profiling import Event, busy_union, reduce_trace

MS = 1_000_000  # ns


def ev(name, a, b, device=False, annotation=False):
    return Event(name, int(a * MS), int(b * MS), device, annotation)


def synthetic():
    """Two frames of 10 ms: render 0-6 (trace kernel 1-2, shading 2-4), composite 6-8 (ghosts 6.5-7.5),
    to_host 8-10 (copy 8-9); the second frame the same 10 ms later."""
    events = []
    for f in (0, 10):
        events += [
            ev("bench.frame", f, f + 10, annotation=True),
            ev("bench.render", f, f + 6, annotation=True),
            ev("bench.composite", f + 6, f + 8, annotation=True),
            ev("bench.to_host", f + 8, f + 10, annotation=True),
            ev("aten::index_add_", f + 4, f + 5.9),
            ev("cudaGraphLaunch", f + 0.5, f + 0.6),
            ev("void (anonymous namespace)::warp_walk_kernel<false, false, 1>(...)", f + 1, f + 2, device=True),
            ev("elementwise_kernel", f + 2, f + 4, device=True),
            ev("ghost_gemm", f + 6.5, f + 7.5, device=True),
            ev("Memcpy DtoH (Device -> Pageable)", f + 8, f + 9, device=True),
            ev("bench.render", f, f + 6, device=True, annotation=True),  # the profiler's device-side range
        ]
    return events


def test_busy_union():
    assert busy_union([(0, 2), (1, 3), (5, 6), (6, 7)]) == 5
    assert busy_union([]) == 0


def test_reduce_trace_per_frame():
    red = reduce_trace(synthetic(), 2)
    assert red["window_s"] == pytest.approx(0.020)
    assert red["busy_s"] == pytest.approx(0.010)  # 5 ms of device work per frame
    assert red["kernels"] == 6  # the copies are not launches
    assert red["span_ms"]["render"] == pytest.approx(3.0)
    assert red["trace_ms"]["render"] == pytest.approx(1.0)
    assert red["kernel_ms"]["composite"] == pytest.approx(1.0)
    assert red["kernel_ms"]["to_host"] == pytest.approx(0.0)
    assert red["span_ms"]["to_host"] == pytest.approx(1.0)
    ops = dict(red["breakdown"]["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(0.004)
    gaps = dict(red["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(0.020 - 0.010 - 0.002)  # idle between the first and last event
    assert gaps["bench.render > aten::index_add_"] == pytest.approx(0.004)  # 4 to 6 ms of each frame
    assert gaps["bench.composite"] == pytest.approx(0.002)  # 6 to 6.5 and 7.5 to 8 ms


def test_reduce_trace_counts_frames():
    with pytest.raises(RuntimeError):
        reduce_trace(synthetic(), 3)


def test_readers_on_the_reduction():
    ctx = {"trace": reduce_trace(synthetic(), 2), "roofline": {"share": 0.03}, "load_s": 0.5, "capture_s": 0.25}
    got = {m: manifest.reader(m)(ctx) for m in (
        "renderer.launches_per_frame", "device.idle_share", "integrator.device_ms_per_frame",
        "trace.device_ms_per_frame", "trace.roofline_share", "flare.device_ms_per_frame",
        "load.scene_s", "compiled.capture_s")}
    assert got["renderer.launches_per_frame"] == 3
    assert got["device.idle_share"] == pytest.approx(50.0)
    assert got["integrator.device_ms_per_frame"] == pytest.approx(2.0)
    assert got["trace.device_ms_per_frame"] == pytest.approx(1.0)
    assert got["trace.roofline_share"] == pytest.approx(3.0)
    assert got["flare.device_ms_per_frame"] == pytest.approx(1.0)
    assert (got["load.scene_s"], got["compiled.capture_s"]) == (0.5, 0.25)


def test_readers_find_nothing_without_a_trace():
    for m in ("renderer.launches_per_frame", "device.idle_share", "trace.roofline_share", "flare.device_ms_per_frame"):
        assert manifest.reader(m)({}) is None


@pytest.fixture(scope="module")
def tree():
    from lens_flare_tpu_torch.accel.wide import build_wide_bvh
    from lens_flare_tpu_torch.ops.intersect_cuda import CudaScene

    from benchlib.scene import terrain

    t = terrain(24, seed=5)
    wb = build_wide_bvh(t.tri_p)
    return t, CudaScene.from_wide_bvh(wb, np.zeros((0, 3), np.float32), np.zeros(0, np.float32), t.num_triangles, "cpu")


def _rays(t, n=512, seed=0):
    g = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 30.0]) + g.normal(0, 3, (n, 3))
    d = np.stack([g.normal(0, 0.3, n), g.normal(0, 0.3, n), -np.ones(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return f(o), f(d), torch.full((n,), 1e-3), torch.full((n,), 1e3)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bound_ignores_the_kernels_own_test_count(tree, any_hit):
    """The work a walk needs does not move when the kernel reports twice the tests."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic

    t, cs = tree
    rays = _rays(t)
    out = ic.tree_plain(cs, *rays, any_hit)
    doubled = (out[0], out[1], out[2], out[3] * 2) + tuple(out[4:])
    kind = "any" if any_hit else "closest"
    w = roofline.work(cs, kind, rays, out)
    assert w == roofline.work(cs, kind, rays, doubled)
    assert w["flops"] > 0 and roofline.bound_ms(w)[0] > 0


def test_bound_counts_k_tests_per_chunk_entered(tree):
    t, cs = tree
    o, d, lo, hi = _rays(t, n=64)
    out = (torch.full((64,), roofline.KINF), torch.full((64,), -1, dtype=torch.int32))
    pairs = sum(int(lanes.numel()) for _, lanes, _ in roofline.chunk_pairs(cs, o, d, lo, hi))
    assert roofline.work(cs, "closest", (o, d, lo, hi), out)["flops"] == pairs * cs.k * roofline.FLOP_PER_TEST["closest"]


def test_device_events_go_to_the_span_that_launched_them():
    """A kernel whose device time is skewed past its span still counts where its launch was."""
    events = [
        ev("bench.frame", 0, 10, annotation=True),
        ev("bench.render", 0, 6, annotation=True),
        ev("bench.composite", 6, 8, annotation=True),
        ev("bench.to_host", 8, 10, annotation=True),
        Event("cudaGraphLaunch", int(6.1 * MS), int(6.2 * MS), False, False, correlation=7),
        Event("ghost_gemm", int(8.5 * MS), int(9.5 * MS), True, False, correlation=7),
        Event("cudaLaunchKernel", int(1 * MS), int(1.1 * MS), False, False, correlation=8),
        Event("elementwise_kernel", int(6.5 * MS), int(7 * MS), True, False, correlation=8),
    ]
    red = reduce_trace(events, 1)
    assert red["kernel_ms"]["composite"] == pytest.approx(1.0)
    assert red["kernel_ms"]["render"] == pytest.approx(0.5)
    assert red["kernel_ms"]["to_host"] == 0


def test_idle_gaps_are_named_on_the_host_clock():
    """Device times 3 ms ahead of the host's: the idle time after the render's last kernel is cut at the
    render's end, and the rest is the tone map's."""
    skew = 3
    events = [
        ev("bench.frame", 0, 10, annotation=True),
        ev("bench.render", 0, 5, annotation=True),
        ev("bench.tone_map", 5, 10, annotation=True),
        Event("cudaGraphLaunch", int(1 * MS), int(1.1 * MS), False, False, correlation=1),
        Event("render_kernel", int((1 + skew) * MS), int((4.9 + skew) * MS), True, False, correlation=1),
        Event("cudaLaunchKernel", int(9.5 * MS), int(9.6 * MS), False, False, correlation=2),
        Event("last_kernel", int((9.5 + skew) * MS), int((9.6 + skew) * MS), True, False, correlation=2),
    ]
    gaps = dict(reduce_trace(events, 1)["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"bench.render": 0.0001, "bench.tone_map": 0.0045})


def test_no_roofline_without_a_cluster_walk(tiny):
    """A scene that takes kernel C's brute force (128 triangles) has no A, B or D walk to read."""
    from benchlib import program
    from benchlib.profiling import Spans

    cell = tiny("terrain_viewer_800x600", n_quads=8)
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 5, "cpu", Spans())
    drv.setup()
    assert drv.r.bundle.cscene.brute
    assert program.trace_roofline(drv.r, drv.terrain, 256, 5) is None
    assert manifest.reader("trace.roofline_share")({"roofline": None}) is None
