"""Cells, configurations, traffic drivers, layer tables and metric readers
are files found by name, and BENCHMARK.json keeps to its contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import devtrace, run as R

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = R.Cell(name)
    assert cell.driver_path.exists()
    assert cell.config["name"] == cell.entry["config"]
    for path in cell.readers.values():
        assert path.exists(), path
        assert hasattr(R.load_module(path, "reader"), "read")
    assert hasattr(R.load_module(cell.driver_path, "driver"), "Driver")
    assert set(cell.workload["limits"]) and cell.end_to_end and cell.per_layer
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert set(cell.workload["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_layer_tables_load_and_name_the_layers():
    layers = devtrace.load_layers()
    assert {"k1", "closest_hit", "tensor_ops"} <= set(layers)
    assert layers["k1"][1].search("void fused_q_level<0, 0, 0, 0, 0, 0>(FusedQArgs, int)")


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a cell by adding files and entries: copy the
    benchmark, add a configuration and a workload file, and the harness
    finds them without an edit to any file that was there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/cornellBox.json").read_text())
    cfg["name"] = "cornellBoxSmall"
    cfg["camera"]["width"] = 300
    (tmp_path / "benchmark/configs/cornellBoxSmall.json").write_text(json.dumps(cfg))
    wl = json.loads((ROOT / "benchmark/workloads/cornellBox.final.json").read_text())
    wl["config"] = "cornellBoxSmall"
    (tmp_path / "benchmark/workloads/cornellBoxSmall.final.json").write_text(json.dumps(wl))
    bench["configs"].append(dict(bench["configs"][0], name="cornellBoxSmall",
                                 file="benchmark/configs/cornellBoxSmall.json"))
    bench["workloads"].append({"name": "cornellBoxSmall.final",
                               "config": "cornellBoxSmall", "traffic": "final",
                               "chips": 1, "why": "a smaller image"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornellBox.final" in m.get("workloads", []):
            m["workloads"].append("cornellBoxSmall.final")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = R.Cell("cornellBoxSmall.final", bench_path=tmp_path / "BENCHMARK.json",
                  root=tmp_path / "benchmark")
    assert cell.config["camera"]["width"] == 300
    assert cell.driver_path == tmp_path / "benchmark/traffic/render.py"
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in R.Cell("cornellBox.final").per_layer}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
