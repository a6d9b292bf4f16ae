"""``benchmark/program_spans.py`` on a hand-made timeline: the program's ranges, their idle time, the labels."""

from types import SimpleNamespace

import pytest
from conftest import BENCH  # noqa: F401  (puts benchlib and the tool on the path)

import program_spans as ps
from benchlib.profiling import Event, reduce_trace

MS = 1_000_000  # ns


def ev(name, a, b, device=False, annotation=False, corr=0):
    return Event(name, int(a * MS), int(b * MS), device, annotation, corr)


def timeline(with_program=True):
    """One 10 ms frame: render 0-8 (prepare 0-3 uploading at 2.5-2.9, one tile 3-7 replaying at 3.1,
    the stats' copy 7-7.9), then the tone map 8-10 launching one kernel at 9.5.  Every device event
    starts 0.1 ms after its launch, so on the host's clock the device is busy 2.5-2.7, 3.1-5.9,
    7.0-7.1 and 9.5-9.6, and idle 2.7-3.1, 5.9-7.0 and 7.1-9.5."""
    events = [
        ev("bench.frame", 0, 10, annotation=True),
        ev("bench.render", 0, 8, annotation=True),
        ev("bench.tone_map", 8, 10, annotation=True),
        ev("cudaMemcpyAsync", 2.5, 2.9, corr=1),
        ev("Memcpy HtoD (Pageable -> Device)", 2.6, 2.8, device=True, corr=1),
        ev("cudaGraphLaunch", 3.1, 3.2, corr=2),
        ev("elementwise_kernel", 3.2, 6.0, device=True, corr=2),
        ev("cudaMemcpyAsync", 7.0, 7.9, corr=3),
        ev("Memcpy DtoH (Device -> Pageable)", 7.1, 7.2, device=True, corr=3),
        ev("cudaLaunchKernel", 9.5, 9.55, corr=4),
        ev("elementwise_kernel", 9.6, 9.7, device=True, corr=4),
    ]
    if with_program:  # the program's ranges: host ranges of the operation kind, not user annotations
        events += [
            ev("lf.renderer.render", 0, 8),
            ev("lf.renderer.prepare", 0, 3),
            ev("lf.renderer.tile", 3, 7),
            ev("lf.renderer.stats", 7, 8),
            ev("lf.image.to_color", 8, 10),
        ]
    return events


def test_program_spans_host_and_idle_ms():
    got = ps.program_spans(timeline(), 1)
    want = {  # host ms, idle ms inside
        "lf.renderer.render": (8.0, 0.4 + 1.1 + 0.9),
        "lf.renderer.prepare": (3.0, 0.3),
        "lf.renderer.tile": (4.0, 0.1 + 1.1),
        "lf.renderer.stats": (1.0, 0.9),
        "lf.image.to_color": (2.0, 1.5),
    }
    assert set(got) == set(want)
    for name, (host, idle) in want.items():
        assert got[name]["host_ms"] == pytest.approx(host), name
        assert got[name]["idle_ms"] == pytest.approx(idle), name
        assert got[name]["count"] == 1


def test_program_spans_per_frame_over_two_frames():
    second = [Event(e.name, e.start + 10 * MS, e.end + 10 * MS, e.device, e.annotation,
                    e.correlation + 10 if e.correlation else 0) for e in timeline()]
    got = ps.program_spans(timeline() + second, 2)
    assert got["lf.renderer.prepare"]["host_ms"] == pytest.approx(3.0)
    # the gap from the first frame's last kernel (9.6 on the host's clock) to the second's upload (12.5)
    # holds the first 2.5 ms of the second frame's prepare: 0.3 + (2.5 + 0.3) over two frames
    assert got["lf.renderer.prepare"]["idle_ms"] == pytest.approx((0.3 + 2.5 + 0.3) / 2)
    assert got["lf.renderer.tile"]["count"] == 1


def test_idle_gaps_named_by_both_ranges_and_the_operation():
    gaps = dict(ps.idle_gaps(timeline(), 1))
    assert gaps == pytest.approx({
        "bench.render > lf.renderer.prepare > cudaMemcpyAsync": 0.3,
        "bench.render > lf.renderer.tile": 0.1 + 1.1,
        "bench.render > lf.renderer.stats > cudaMemcpyAsync": 0.9,
        "bench.tone_map > lf.image.to_color": 1.5,
    })


def test_a_program_without_ranges():
    assert ps.program_spans(timeline(with_program=False), 1) == {}
    gaps = dict(ps.idle_gaps(timeline(with_program=False), 1))
    # uncut, the first gap (2.7-3.1) is named whole by the upload open when it began
    assert gaps == pytest.approx({"bench.render > cudaMemcpyAsync": 0.4 + 0.9, "bench.render": 1.1,
                                  "bench.tone_map": 1.5})


def test_the_programs_ranges_move_no_number_the_harness_reports():
    """To the harness's reduction the program's ranges are operations: every number it reports is the
    same with and without them, and the idle time it names sums to the same; only labels may change."""
    with_, without = reduce_trace(timeline(), 1), reduce_trace(timeline(with_program=False), 1)
    gaps_with, gaps_without = with_["breakdown"].pop("idle_gaps"), without["breakdown"].pop("idle_gaps")
    assert with_ == without
    assert sum(s for _, s in gaps_with) == pytest.approx(sum(s for _, s in gaps_without))


def test_a_device_annotation_moves_no_offset():
    """The device's copy of a user annotation carries its host range's correlation id; where a runtime
    call has the same id, it is no launch: the offset stays the least lag of the real launches."""
    events = timeline() + [ev("bench.render", 2.6, 6.0, device=True, annotation=True, corr=4)]
    assert ps.timeline(events, 1)[1] == ps.timeline(timeline(), 1)[1] == int(0.1 * MS)
    assert ps.program_spans(events, 1) == ps.program_spans(timeline(), 1)


def test_counters_read_only_a_program_that_counts():
    counting = SimpleNamespace(replays=3, copies_in=39)
    r = SimpleNamespace(_programs=counting, _flare_programs=SimpleNamespace(replays=1, copies_in=8))
    assert ps.counters(r) == {"replays": 4, "copies_in": 47}
    assert ps.counters(SimpleNamespace(_programs=counting, _flare_programs=SimpleNamespace())) is None
