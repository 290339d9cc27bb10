"""Nothing the benchmark runs imports JAX or the JAX package, the reference
imports nothing of the program, and the command refuses to run without a
card or without the program beside it.  Names are compared whole, by their
top-level module: ``skdownscale_tpu_torch`` is not ``skdownscale_tpu``."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from portbench import catalog, harness

HERE = catalog.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "skdownscale_tpu"}
OLD_FOLDER = "bench" + "marks"  # the JAX package's benchmarks, which nothing here reads


def imported_tops(path) -> set:
    """The top-level names of every absolute import in a source file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if s == OLD_FOLDER or s.startswith(OLD_FOLDER + "/") or f"/{OLD_FOLDER}/" in s]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "skdownscale_tpu_torch" not in imported_tops(path)
    assert "skdownscale_tpu_torch" not in path.read_text()


def test_whole_names():
    assert harness.forbidden_modules(["skdownscale_tpu_torch", "skdownscale_tpu_torch.models.mbc", "numpy",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["skdownscale_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "skdownscale_tpu"]


def test_this_process_is_clean_after_a_run():
    from small import small_cell

    harness.run("qm_detrend.30y", 3, 0.2, False, "cpu", cell=small_cell("qm_detrend.30y"), log=lambda s: None)
    assert harness.forbidden_modules() == []


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_no_card_no_result():
    proc = _run(HERE.parent, "--workload", "mbcn.30y", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and _no_result(proc), proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "--workload", "qm_detrend.30y", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and _no_result(proc)
    assert "skdownscale_tpu_torch" in proc.stderr


def test_the_json_line_shape():
    from small import small_cell

    result = harness.run("mbcn.30y", 2**31 + 11, 0.2, False, "cpu", cell=small_cell("mbcn.30y"), log=lambda s: None)
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) <= {m["name"] for m in catalog.metrics_for("mbcn.30y", False)}
    assert json.loads(json.dumps(result)) == result
