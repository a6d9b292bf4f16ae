"""``BENCHMARK.json`` against the contract's characters and keys; every piece found by its file name."""

import json
import shutil

import pytest
from conftest import BENCH, CELLS, run_cpu, shrink

from benchlib import manifest

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE_FIELDS = ("why", "layer", "source")


def bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_keys_and_limits():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert [m for m in b["end_to_end"] if m["name"] == "setup_s"][0]["bound"] == 0.25


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[group]:
            names.append(entry["name"])
            assert manifest.NAME.match(entry["name"]), entry["name"]
            for key in ("config", "traffic"):
                if key in entry:
                    assert manifest.NAME.match(entry[key])
            for key in entry.get("reduced", []):
                assert manifest.NAME.match(key)
            if "unit" in entry:
                assert manifest.UNIT.match(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
            for key in LINE_FIELDS:
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[group]}) == len(b[group])
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_what_it_must():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "frame_s", "frame_p95_s"} <= e2e
    for w in b["workloads"]:
        cell = manifest.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e


def test_files_found_by_name():
    b = bench()
    for c in b["configs"]:
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(manifest.driver(cell.traffic["kind"]))
        assert set(cell.workload["limits"]) and cell.workload["check"]["pixels"] > 0
    for m in b["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    with pytest.raises(KeyError):
        manifest.load_cell("no_such_cell")
    with pytest.raises(ValueError):
        manifest.reader("../run")


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A copy of the benchmark gains a cell through new files and a new entry only, and runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "terrain_orbit_small", "config": "terrain512_paraxial",
                           "traffic": "orbit_small", "chips": 1, "why": "a smaller orbit"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((BENCH / "traffic" / "orbit_1080p.json").read_text())
    traffic.update(width=40, height=24)
    (root / "benchmark" / "traffic" / "orbit_small.json").write_text(json.dumps(traffic))
    workload = json.loads((BENCH / "workloads" / "terrain_orbit_1080p.json").read_text())
    workload["traffic"] = "orbit_small"
    (root / "benchmark" / "workloads" / "terrain_orbit_small.json").write_text(json.dumps(workload))
    before = {p.relative_to(BENCH) : p.read_bytes() for p in BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    for rel, data in before.items():
        assert (root / "benchmark" / rel).read_bytes() == data
    cell = manifest.load_cell("terrain_orbit_small", bench_dir=root / "benchmark")
    assert (cell.traffic["width"], cell.traffic["height"]) == (40, 24)
    res, _ = run_cpu(shrink(cell, width=40, height=24))
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_agree(name):
    cell = manifest.load_cell(name)
    assert cell.entry["why"] == cell.workload["why"]
    assert cell.workload["chips"] == cell.entry["chips"] == 1
