"""One run of one cell: set-up, warm-up, the measured window, the traced slice, the check, the result line."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import compare, manifest
from .driver import rng_for
from .profiling import Spans, raw_events, reduce_trace

# top-level module names a run may not hold: JAX and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "lens_flare_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default ``sys.modules``), compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card() -> str:
    """The card's ``name, power.limit`` line from ``nvidia-smi`` (empty where it is absent)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        out=None, err=None) -> dict:
    """Run ``cell`` and print its result; returns the result (None when forbidden modules were found)."""
    out = out or sys.stdout
    err = err or sys.stderr
    spans = Spans()
    drv = manifest.driver(cell.traffic["kind"], cell.bench_dir)(cell.config, cell.traffic, seed, device, spans)
    drv.setup()
    warm = int(cell.traffic["warm_frames"])
    for g in range(warm):
        with spans("frame"):
            drv.frame(g)
    _sync(device)
    setup_s = time.perf_counter() - t0
    load_s = spans.seconds.get("load", 0.0)
    setup_spans = dict(spans.seconds)

    check = cell.workload["check"]
    drawn = {int(i) for i in rng_for(seed, 3).choice(int(check["from_first"]), int(check["frames"]), replace=False)}
    kept, lat = {}, []
    n_programs = drv.programs()
    start = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        with spans("frame"):
            result = drv.frame(warm + i)
        b = time.perf_counter()
        lat.append(b - a)
        if i in drawn:
            kept[warm + i] = result
        last = (warm + i, result)
        i += 1
        if b - start >= seconds:
            break
    window_s = b - start
    q = np.percentile(lat, [0, 50, 95, 100])
    window_spans = {k: round(v - setup_spans.get(k, 0.0), 4) for k, v in spans.seconds.items()}
    print(f"[bench] set-up {setup_s:.3f} s, host s per span {dict((k, round(v, 4)) for k, v in setup_spans.items())}; "
          f"window {window_s:.3f} s, {len(lat)} frames; latency min/median/p95/max "
          f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}/{q[3]:.4f} s; host s per span {window_spans}; programs captured "
          f"in the window {drv.programs() - n_programs}", file=err)
    kept[last[0]] = last[1]
    del result, last
    n_frames = i

    ctx = {"load_s": load_s}
    device_info = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        n_trace = int(cell.workload["trace_frames"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        with profile(activities=acts) as prof:
            for g in range(warm + n_frames, warm + n_frames + n_trace):
                with spans("frame"):
                    drv.frame(g)
            _sync(device)
        red = reduce_trace(raw_events(prof), n_trace)
        del prof
        ctx["trace"] = red
        ctx["roofline"] = drv.roofline()
        device_info = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
        if ctx["roofline"] is not None:
            print(f"[bench] roofline {json.dumps(ctx['roofline'])}", file=err)
    ctx["capture_s"] = drv.capture_s()
    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    drv.release()

    per_frame = drv.check(kept, int(check["pixels"]))
    correct, failed, checks = compare.judge(per_frame, cell.workload["limits"])

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "frame_s": window_s / n_frames,
                  "frame_p95_s": float(np.percentile(lat, 95))}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = manifest.reader(m["name"], cell.bench_dir)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded in this process: {found}", file=err)
        return None
    is_cuda = torch.device(device).type == "cuda"
    res = {
        "correct": bool(correct),
        "attempted": n_frames,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if is_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
            **device_info,
        },
    }
    if trace:
        res["breakdown"] = ctx["trace"]["breakdown"]
    res["card"] = card() if is_cuda else ""
    res["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=err)
    print(json.dumps(res), file=out, flush=True)
    return res
