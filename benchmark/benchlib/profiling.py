"""Spans around the harness's calls, and the reduction of a profiler trace to per-frame numbers.

The harness wraps each call it makes into a layer of the program in
:func:`span` (a ``torch.profiler.record_function`` range plus a host clock),
and profiles a bounded slice of frames after the measured window.  The
reduction (:func:`reduce_trace`) reads the profiler's raw events: host
ranges named ``bench.*``, the host operations under them, and the device's
kernels, copies and fills.  A device event belongs to the host span in which
it started: every frame ends with a copy to the host, which waits for the
device, so no frame's work runs into the next one's span.

The busy time is the union of the device intervals (frozen from
``lens_flare_tpu_torch/ab_walk.py:frame_profile``); each idle gap between
them, moved onto the host's clock by the least lag from a launch to its
device event, is cut where host ranges begin or end, and each piece is
named by the innermost host range open over it and the innermost host
operation open when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

import torch

# the trace kernels of ops/csrc/intersect.cu, as the profiler names them
SHORT_GAP_NS = 20_000  # idle gaps shorter than this are summed per host range, not named by operation
TRACE_KERNELS = (
    "warp_walk_kernel", "brute_kernel", "group_walk_kernel", "group_list_kernel",
    "group_continue_kernel", "mxu_walk_kernel", "bvh_walk_kernel",
)


@dataclass
class Spans:
    """Host seconds per span name, summed over calls."""

    seconds: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    device: bool
    annotation: bool
    correlation: int = 0  # links a device event to the host call that launched it (0: none)


def raw_events(prof) -> list[Event]:
    """Every event of a finished ``torch.profiler.profile`` (its kineto results), times in ns on one clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        ann = bool(e.is_user_annotation()) or (dev and e.name().startswith("bench."))
        out.append(Event(e.name(), start, start + int(e.duration_ns()), dev, ann, int(e.correlation_id())))
    return out


def busy_union(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, lo, hi = 0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def is_trace_kernel(name: str) -> bool:
    return any(k in name for k in TRACE_KERNELS)


def reduce_trace(events: list[Event], n_frames: int, top: int = 10) -> dict:
    """Per-frame numbers of a traced slice of ``n_frames`` frames, each under a ``bench.frame`` span.

    Returns window and busy seconds, kernel launches, device ms per frame per
    span (``span_ms``: every device event started inside a span of that name;
    ``kernel_ms``: its kernels, copies and fills left out; ``trace_ms``: the
    trace kernels among them), and the breakdown.
    """
    host = [e for e in events if not e.device and e.annotation and e.name.startswith("bench.")]
    frames = sorted((e.start, e.end) for e in host if e.name == "bench.frame")
    if len(frames) != n_frames:
        raise RuntimeError(f"the trace holds {len(frames)} frame spans, not {n_frames}")
    w0, w1 = frames[0][0], frames[-1][1]
    # the host time of each device event's launch, where the profiler links them
    launched = {e.correlation: e.start for e in events
                if not e.device and e.correlation and e.name.startswith("cuda")}

    def at(e):
        return launched.get(e.correlation, e.start) if e.correlation else e.start

    # the device clock's lead over the host's: no event starts before its launch, so the least
    # (start - launch) over linked events is the offset plus the shortest launch latency
    lags = [e.start - launched[e.correlation] for e in events if e.device and e.correlation in launched]
    offset = min(lags) if lags else 0

    dev = [e for e in events if e.device and not e.annotation and w0 <= at(e) <= w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device events in the traced frames")
    dev.sort(key=lambda e: e.start)
    busy = busy_union((e.start, min(e.end, w1)) for e in dev)

    spans = {}
    for e in host:
        if e.name != "bench.frame":
            spans.setdefault(e.name[len("bench."):], []).append((e.start, e.end))
    span_ms, kernel_ms, trace_ms = {}, {}, {}
    for name, ivs in spans.items():
        ivs.sort()
        starts = [a for a, _ in ivs]
        tot = ker = tr = 0
        for e in dev:
            t = at(e)
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= ivs[k][1]:
                tot += e.end - e.start
                if is_kernel(e.name):
                    ker += e.end - e.start
                if is_trace_kernel(e.name):
                    tr += e.end - e.start
        span_ms[name] = tot / 1e6 / n_frames
        kernel_ms[name] = ker / 1e6 / n_frames
        trace_ms[name] = tr / 1e6 / n_frames

    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps inside the slice, named by the innermost host range open when each began and, for
    # gaps of SHORT_GAP_NS or more, the innermost host operation open then
    host_sorted = sorted(host, key=lambda e: e.start)
    host_starts = [e.start for e in host_sorted]
    ops = sorted((e for e in events if not e.device and not e.annotation), key=lambda e: e.start)
    op_starts = [e.start for e in ops]

    def innermost(items, starts, t, depth):
        k = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(k, max(k - depth, -1), -1):
            e = items[j]
            if e.end >= t and (best is None or e.end - e.start < best.end - best.start):
                best = e
        return best

    # each idle gap, on the host's clock, split where host ranges begin or end; each piece is named by
    # the innermost range open over it and, for pieces of SHORT_GAP_NS or more, the innermost operation
    # open when it began
    bounds = sorted({t for e in host_sorted for t in (e.start, e.end)})
    named, hi = {}, None
    for e in dev:
        if hi is not None and e.start > hi:
            g0, g1 = hi - offset, e.start - offset
            cuts = [g0] + bounds[bisect.bisect_right(bounds, g0):bisect.bisect_left(bounds, g1)] + [g1]
            for a, b in zip(cuts, cuts[1:]):
                rng_ = innermost(host_sorted, host_starts, (a + b) // 2, 16)
                label = rng_.name if rng_ is not None else "outside"
                if b - a >= SHORT_GAP_NS:
                    op = innermost(ops, op_starts, a, 64)
                    label = f"{label} > {op.name}" if op is not None else label
                else:
                    label = f"{label} > gaps under {SHORT_GAP_NS // 1000} us"
                named[label] = named.get(label, 0) + (b - a)
        hi = e.end if hi is None else max(hi, e.end)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {
        "frames": n_frames,
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": sum(1 for e in dev if is_kernel(e.name)),
        "span_ms": span_ms,
        "kernel_ms": kernel_ms,
        "trace_ms": trace_ms,
        "breakdown": {
            "device_ops": [[n, s / 1e9] for n, s in device_ops],
            "idle_gaps": [[n, s / 1e9] for n, s in idle],
        },
    }
