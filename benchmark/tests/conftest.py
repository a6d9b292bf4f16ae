"""Helpers of the benchmark's CPU tests: its cells shrunk to sizes a test run holds.

Run them from the root of the repo: ``python -m pytest benchmark/tests -q``.
"""

import copy
import io
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import harness, manifest  # noqa: E402

CELLS = ("terrain_orbit_1080p", "config2_adaptive_1080p", "terrain_viewer_800x600")


def shrink(cell: manifest.Cell, n_quads: int = 8, width: int = 48, height: int = 32) -> manifest.Cell:
    """The cell at a CPU test's size: a terrain of 2 * n_quads**2 triangles, a small film, 300 pixels checked."""
    cell = copy.deepcopy(cell)
    cell.config["scene"]["n_quads"] = n_quads
    cell.config["render"]["tile_pixels"] = 1024
    cell.traffic["width"], cell.traffic["height"] = width, height
    cell.workload["check"]["pixels"] = 300
    return cell


def run_cpu(cell: manifest.Cell, seed: int = 2**31 + 77, seconds: float = 1.0):
    """One run of ``cell`` on the CPU, the harness's look for a card skipped: (result, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    res = harness.run(cell, seed, seconds, False, "cpu", time.perf_counter(), out=out, err=err)
    return res, err.getvalue()


@pytest.fixture
def tiny():
    return lambda name, **kw: shrink(manifest.load_cell(name), **kw)
