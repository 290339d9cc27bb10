"""Everything the harness runs, found by name.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its configuration, traffic
mix, chips, why and the limits of its check); a configuration ``<config>``
is ``configs/<config>.json``, whose ``system`` names the module of
``systems/`` that drives and judges it; a traffic mix ``<mix>`` is the data
file ``traffic/<mix>.json`` that :mod:`portbench.generator` reads; a metric
``<metric>`` is the reader ``metrics/<metric>.py``; a kernel's operations
and bytes are ``roofline/<kernel>.py``.  The metrics a cell reports are
those ``BENCHMARK.json`` lists for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name) or ".." in name:
        raise ValueError(f"not a name of this benchmark: {name!r}")
    return name


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` as a dict (``kind``: workloads, configs,
    traffic)."""
    path = HERE / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    """A cell with its configuration and traffic mix resolved:
    ``{"name", "config": {...}, "traffic": {...}, "chips", "why",
    "limits"}``."""
    w = load("workloads", name)
    return {**w, "name": name, "config": load("configs", w["config"]), "traffic": load("traffic", w["traffic"])}


def system(name: str):
    """The module ``systems/<name>.py``."""
    return importlib.import_module(f"portbench.systems.{_checked(name)}")


def roofline(kernel: str):
    """The module ``roofline/<kernel>.py``."""
    return importlib.import_module(f"portbench.roofline.{_checked(kernel)}")


def roofline_kernels() -> list[str]:
    """The kernels that ``roofline/`` holds a yardstick for."""
    return sorted(p.stem for p in (HERE / "roofline").glob("*.py") if p.stem != "__init__")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py`` (metric names hold dots, so
    the file is loaded by its path)."""
    path = HERE / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def metrics_for(cell_name: str, trace: bool, bench: dict | None = None) -> list[dict]:
    """The metric entries of ``BENCHMARK.json`` that the cell reports: its
    end-to-end metrics with ``trace`` off, its per-layer metrics with it
    on; an entry with ``workloads`` applies to the cells it lists."""
    bench = bench or benchmark()
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if "workloads" not in m or cell_name in m["workloads"]]
