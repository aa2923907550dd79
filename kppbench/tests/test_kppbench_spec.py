"""BENCHMARK.json keeps the contract's naming rules, every cell resolves
to its files, and new files are found by name without an edit."""

import json
import os
import shutil

import pytest

from kppbench import spec

ROOT = spec.ROOT


def test_names_units_and_keys():
    bench = spec.load_benchmark(ROOT)
    assert spec.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["kppbench"]
    assert all(len(w) <= 200 for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["per_layer"]:
        assert m["moves"] in names
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("workload", [
    w["name"] for w in spec.load_benchmark(ROOT)["workloads"]])
def test_cell_resolves(workload):
    bench = spec.load_benchmark(ROOT)
    cell = spec.resolve(workload, ROOT)
    entry = next(c for c in bench["configs"]
                 if c["name"] == cell.config["name"])
    assert entry["file"].startswith("kppbench/")
    assert cell.chips == 1
    assert cell.traffic["streams"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"], ROOT))
    for m in bench["per_layer"]:
        for w in m.get("workloads", []):
            spec.resolve(w, ROOT)


def test_new_files_are_found(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and entries resolve with no edit of a file that is there."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "kppbench"), root / "kppbench",
                    ignore=shutil.ignore_patterns("_work", "_cache",
                                                  "__pycache__"))
    bench = spec.load_benchmark(ROOT)
    kb = root / "kppbench"
    cfg = json.loads((kb / "configs" / "terramaris.json").read_text())
    cfg.update(name="regional_64x64", nx=64, ny=64, nz=40)
    (kb / "configs" / "regional_64x64.json").write_text(json.dumps(cfg))
    (kb / "limits" / "regional_64x64.json").write_text(
        (kb / "limits" / "terramaris.json").read_text())
    traffic = json.loads((kb / "traffic" / "kpp_means.json").read_text())
    traffic["name"] = "six_hourly"
    traffic["streams"][0]["output_freq"] = "6h"
    (kb / "traffic" / "six_hourly.json").write_text(json.dumps(traffic))
    (kb / "cells" / "regional_64x64.six_hourly.json").write_text(
        json.dumps({"steps_per_s": 300.0, "why": "a new cell"}))
    (kb / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run.steps\n")
    bench["configs"].append({"name": "regional_64x64",
                             "source": "https://example.org/regional",
                             "file": "kppbench/configs/regional_64x64.json",
                             "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({"name": "regional_64x64.six_hourly",
                               "config": "regional_64x64",
                               "traffic": "six_hourly", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "cli", "moves": "col_steps_per_s",
                               "workloads": ["regional_64x64.six_hourly"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("regional_64x64.six_hourly", str(root))
    assert cell.config["nx"] == 64 and cell.steps_per_s == 300.0
    assert cell.traffic["streams"][0]["output_freq"] == "6h"
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window"]
    assert spec.reader("steps_in_window", str(root))(
        type("R", (), {"steps": 7})()) == 7
    assert spec.problems(json.loads((root / "BENCHMARK.json").read_text())) \
        == []
    old = spec.resolve("terramaris.kpp_means", str(root))
    assert len(old.per_layer) == 6
