"""Every cell, configuration, traffic mix, system, metric and kernel that
``BENCHMARK.json`` names is found by its name, and the file keeps to the
benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import catalog

BENCH = catalog.benchmark()
HERE = catalog.HERE
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((HERE.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"cells_per_s", "peak_mem_gib", "setup_s"} <= names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for c in CELLS:
        e2e = [m["name"] for m in catalog.metrics_for(c, False, BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_for(c, True, BENCH)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_agree(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    cell = catalog.cell(name)
    for key in ("config", "traffic", "chips", "why"):
        assert catalog.load("workloads", name)[key] == entry[key]
    assert entry["chips"] == 1
    module = catalog.system(cell["config"]["system"])
    assert set(cell["limits"]) == set(module.NUMBERS)
    assert set(module.FIELDS) <= set(cell["traffic"]["fields"])
    assert module.CONTROLS


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    config = json.loads((HERE.parent / entry["file"]).read_text())
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert catalog.system(config["system"]).System
    for name in config["kernels"]:
        assert (HERE.parent / "skdownscale_tpu_torch" / "csrc" / f"{name}.cu").is_file()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_every_metric_has_its_reader_and_every_reader_a_metric():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert named == files
    for name in named:
        assert callable(catalog.metric_reader(name))


def test_roofline_metrics_have_their_kernel():
    for m in BENCH["per_layer"]:
        if m["name"].endswith(".roofline_pct"):
            mod = catalog.roofline(m["name"].split(".")[0])
            assert mod.NAMES and callable(mod.cost) and mod.LAUNCH
            for module_name, fn_name in mod.LAUNCH:  # the program still has each launch function
                assert callable(getattr(importlib.import_module(module_name), fn_name))


def test_names_outside_the_benchmark_are_refused():
    for bad in ("../BENCHMARK", "a/b", "", ".hidden", "x" * 65):
        with pytest.raises(ValueError):
            catalog.load("workloads", bad)
    with pytest.raises(FileNotFoundError):
        catalog.cell("no_such_cell")


def test_benchmark_folder_holds_the_benchmark_only():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert path.suffix in ("", ".py", ".json"), path
        rel = path.relative_to(HERE.parent).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel
    assert Path(HERE / "run.py").is_file()
