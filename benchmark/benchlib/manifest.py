"""``BENCHMARK.json`` and the files the harness finds by name.

- a configuration: ``benchmark/configs/<config>.json``;
- a cell: ``benchmark/workloads/<cell>.json`` (its check: frames, pixels, limits);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind`` names the
  driver ``benchmark/drivers/<kind>.py`` that generates it;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose ``read(ctx)``
  returns the number, or None where the run has nothing to read.

A cell is added by adding files: a workload entry in ``BENCHMARK.json``, its
workload file, and, where they are new, a traffic file, a configuration
file and metric readers.  No file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    entry: dict  # the workloads entry of BENCHMARK.json
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports
    bench_dir: Path = BENCH_DIR  # where its drivers and metric readers are found


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR, manifest: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    bench = load_json(manifest or bench_dir.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another configuration or traffic than BENCHMARK.json")
    return Cell(
        name=name, entry=entry, workload=workload,
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        bench_dir=bench_dir,
    )


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, bench_dir: Path = BENCH_DIR):
    """The ``Driver`` class of ``drivers/<kind>.py``."""
    if not NAME.match(kind):
        raise ValueError(f"not a traffic kind: {kind!r}")
    return _module(bench_dir / "drivers" / f"{kind}.py", f"bench_driver_{kind}").Driver


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"not a metric name: {metric!r}")
    return _module(bench_dir / "metrics" / f"{metric}.py", "bench_metric_" + metric.replace(".", "_")).read
