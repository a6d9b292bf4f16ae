#!/usr/bin/env python3
"""The program's own spans and counters in a traced slice of one cell.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> [--frames N] [--first G] [--out FILE]

Run from the root of a checkout, on a CUDA card.  It sets the cell up as
``benchmark/run.py`` does, renders frames up to ``G`` untraced (the
warm-up's and more), then profiles ``N`` frames (the cell's
``trace_frames`` by default) and prints one JSON line: the slice's
seconds per frame and idle share (beside the median of the last four
untraced frames), the harness's own breakdown
(``benchlib/profiling.py:reduce_trace``) and, from the program's ``lf.*``
ranges (``lens_flare_tpu_torch/utils/profiling.py:span``):

- ``program``: per range name, its host ms per frame (the union of its
  ranges), the device's idle ms per frame inside them (the idle gaps of
  ``reduce_trace``, moved onto the host's clock by the least launch lag,
  ``offset_us``), and the ranges opened per frame;
- ``idle_gaps``: the idle gaps cut where the harness's and the program's
  ranges begin and end, each piece named by the innermost ``bench.*``
  range, then the innermost ``lf.*`` range, then the innermost operation
  open when it began (ms per frame, the largest first);
- ``counters``: the captured programs' replays and input copies per frame
  (``Programs.replays``, ``Programs.copies_in`` of the renderer's frame
  and ghost-buffer programs), absent where the program has none.

It checks no output and reports no metric of ``BENCHMARK.json``: it shows
where a frame's host time and the device's idle time sit in the program's
code.  A program without ``lf.*`` ranges gives an empty ``program``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"
PREFIX = "lf."


def _merge(intervals) -> list:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged_a, merged_b) -> int:
    """Length of the intersection of two unions given as sorted, disjoint intervals."""
    i = j = total = 0
    while i < len(merged_a) and j < len(merged_b):
        lo = max(merged_a[i][0], merged_b[j][0])
        hi = min(merged_a[i][1], merged_b[j][1])
        total += max(0, hi - lo)
        if merged_a[i][1] < merged_b[j][1]:
            i += 1
        else:
            j += 1
    return total


def timeline(events, n_frames: int):
    """(frame window (w0, w1), device offset, the device's idle gaps on the host's clock), as
    ``reduce_trace`` finds them: device events launched inside the frames, the least launch lag as
    the offset, and the gaps between the union of their intervals, from the first to the last.  Unlike
    ``reduce_trace`` the lag leaves out the device's copies of user annotations (the ``bench.*``
    ranges): they carry their host range's correlation id, which may also be a runtime call's."""
    frames = sorted((e.start, e.end) for e in events
                    if not e.device and e.annotation and e.name == "bench.frame")
    if len(frames) != n_frames:
        raise RuntimeError(f"the trace holds {len(frames)} frame spans, not {n_frames}")
    w0, w1 = frames[0][0], frames[-1][1]
    launched = {e.correlation: e.start for e in events
                if not e.device and e.correlation and e.name.startswith("cuda")}

    def at(e):
        return launched.get(e.correlation, e.start) if e.correlation else e.start

    lags = [e.start - launched[e.correlation] for e in events
            if e.device and not e.annotation and e.correlation in launched]
    offset = min(lags) if lags else 0
    dev = [e for e in events if e.device and not e.annotation and w0 <= at(e) <= w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device events in the traced frames")
    busy = _merge((e.start, min(e.end, w1)) for e in dev)
    gaps = [(a[1] - offset, b[0] - offset) for a, b in zip(busy, busy[1:])]
    return (w0, w1), offset, gaps


def program_spans(events, n_frames: int) -> dict:
    """{lf name: {host_ms, idle_ms, count}} per frame, over the ``bench.frame`` ranges of the slice."""
    (w0, w1), _, gaps = timeline(events, n_frames)
    by_name = {}
    for e in events:
        if not e.device and e.name.startswith(PREFIX) and e.end >= w0 and e.start <= w1:
            by_name.setdefault(e.name, []).append((max(e.start, w0), min(e.end, w1)))
    out = {}
    for name, ivs in sorted(by_name.items()):
        merged = _merge(ivs)
        out[name] = {
            "host_ms": sum(b - a for a, b in merged) / 1e6 / n_frames,
            "idle_ms": _overlap(merged, gaps) / 1e6 / n_frames,
            "count": len(ivs) / n_frames,
        }
    return out


def idle_gaps(events, n_frames: int, top: int = 15) -> list:
    """[label, ms per frame] of the slice's idle gaps, cut where ``bench.*`` and ``lf.*`` ranges begin
    and end, labelled ``bench.X > lf.Y > op``: the innermost range of each kind open over the piece and
    the innermost operation open when it began (operations only for pieces of SHORT_GAP_NS or more)."""
    from benchlib.profiling import SHORT_GAP_NS

    _, _, gaps = timeline(events, n_frames)
    kinds = {
        "bench": [e for e in events if not e.device and e.annotation and e.name.startswith("bench.")],
        "lf": [e for e in events if not e.device and e.name.startswith(PREFIX)],
        "op": [e for e in events if not e.device and not e.annotation and not e.name.startswith(PREFIX)],
    }
    index = {}
    for k, items in kinds.items():
        items.sort(key=lambda e: e.start)
        index[k] = (items, [e.start for e in items])

    def open_at(kind, t):
        """The innermost range of ``kind`` open at ``t``: ranges of one thread nest, so it is the last
        one begun by ``t`` that has not ended."""
        items, starts = index[kind]
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if items[j].end >= t:
                return items[j]
        return None

    def op_at(t, depth=64):
        """The shortest operation open at ``t`` among the ``depth`` last begun, as ``reduce_trace`` names it."""
        items, starts = index["op"]
        k = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(k, max(k - depth, -1), -1):
            e = items[j]
            if e.end >= t and (best is None or e.end - e.start < best.end - best.start):
                best = e
        return best

    bounds = sorted({t for k in ("bench", "lf") for e in kinds[k] for t in (e.start, e.end)})
    named = {}
    for g0, g1 in gaps:
        cuts = [g0] + bounds[bisect.bisect_right(bounds, g0):bisect.bisect_left(bounds, g1)] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) // 2
            parts = [r.name for r in (open_at("bench", mid), open_at("lf", mid)) if r is not None]
            if b - a >= SHORT_GAP_NS:
                op = op_at(a)
                parts += [op.name] if op is not None else []
            else:
                parts.append(f"gaps under {SHORT_GAP_NS // 1000} us")
            label = " > ".join(parts) or "outside"
            named[label] = named.get(label, 0) + (b - a)
    return [[k, v / 1e6 / n_frames] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:top]]


def counters(r) -> dict | None:
    """The renderer's captured programs' replays and input copies, summed; None where it counts none."""
    progs = (r._programs, r._flare_programs)
    if not all(hasattr(p, "replays") for p in progs):
        return None
    return {"replays": sum(p.replays for p in progs), "copies_in": sum(p.copies_in for p in progs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=None, help="frames traced (default: the cell's trace_frames)")
    ap.add_argument("--first", type=int, default=None, help="the first traced frame (default: 8 after the warm-up)")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import harness, manifest
    from benchlib.profiling import Spans, raw_events, reduce_trace

    if not torch.cuda.is_available():
        print("[spans] needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(args.workload)
    n = int(args.frames or cell.workload["trace_frames"])
    spans = Spans()
    drv = manifest.driver(cell.traffic["kind"], cell.bench_dir)(cell.config, cell.traffic, args.seed, "cuda", spans)
    drv.setup()
    first = int(cell.traffic["warm_frames"]) + 8 if args.first is None else args.first
    lat = []
    for g in range(first):
        t0 = time.perf_counter()
        with spans("frame"):
            drv.frame(g)
        lat.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    before = counters(drv.r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for g in range(first, first + n):
            with spans("frame"):
                drv.frame(g)
        torch.cuda.synchronize()
    after = counters(drv.r)
    events = raw_events(prof)
    del prof
    red = reduce_trace(events, n)
    res = {
        "workload": args.workload, "seed": args.seed, "frames": n, "first": first, "card": harness.card(),
        "untraced_s_per_frame": statistics.median(lat[-4:]), "s_per_frame": red["window_s"] / n,
        "idle_share": 1.0 - red["busy_s"] / red["window_s"], "offset_us": timeline(events, n)[1] / 1e3,
        "program": program_spans(events, n),
        "idle_gaps": idle_gaps(events, n),
        "harness_idle_gaps": [[k, s * 1e3 / n] for k, s in red["breakdown"]["idle_gaps"]],
    }
    if before is not None:
        res["counters"] = {k: (after[k] - before[k]) / n for k in before}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
