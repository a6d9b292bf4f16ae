"""``trace.live_lane_share``: the reader, and the driver's count of a frame's live rays and handed lanes."""

import types

import pytest
import torch
from conftest import BENCH  # noqa: F401  (puts benchlib on the path)

from benchlib import manifest
from benchlib.profiling import Spans

READ = manifest.reader("trace.live_lane_share")


def test_reader():
    assert READ({"roofline": {"share": 0.05, "live_lane_share": 12.5}}) == 12.5
    assert READ({"roofline": {"share": 0.05}}) is None  # a program that counts no lanes
    assert READ({"roofline": None}) is None and READ({}) is None


@pytest.fixture
def still():
    torch.set_num_threads(1)
    cell = manifest.load_cell("cornell_256_16spp")
    cell.config["render"]["tile_pixels"] = 1024
    cell.traffic["width"], cell.traffic["height"] = 48, 32
    cell.traffic["render"]["ns_aa"] = 2
    drv = manifest.driver(cell.traffic["kind"])(cell.config, cell.traffic, 2**33 + 5, "cpu", Spans())
    drv.setup()
    return drv


def test_live_rays_over_handed_lanes(still):
    """One frame: two 1,024-lane tiles x 2 samples x 5 vertices, one closest-hit and four shadow lanes a
    vertex, handed to A and C; the live rays are ``RenderStats.total_rays``."""
    still.frame(0)
    rays, lanes = still.traced
    assert lanes == 2 * 1024 * 2 * 5 * (1 + 4) and rays == still.r.stats.total_rays
    assert 0 < rays < lanes
    out = still.roofline()
    assert out["share"] == 0.0  # the CPU times nothing: trace.roofline_share reads None
    assert manifest.reader("trace.roofline_share")({"roofline": out}) is None
    assert READ({"roofline": out}) == pytest.approx(100.0 * rays / lanes)


def test_a_program_without_the_counter_reads_none(still, monkeypatch):
    """Where the trace kernels count no lanes (the program before the counter), the frame runs, the
    driver records nothing and the reader reads None, raising nothing."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic

    still.frame(0)
    monkeypatch.setattr(ic, "KERNELS", {k: types.SimpleNamespace(launches=0) for k in ic.KERNELS})
    assert type(still).frame.__globals__["handed_lanes"]() is None
    still.traced = None
    assert READ({"roofline": still.roofline()}) is None
