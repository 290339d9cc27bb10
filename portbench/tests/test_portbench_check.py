"""The check that decides ``correct``, at sizes a CPU test holds: sound runs
of the program pass; each control (the plain reference one step below the
configuration's precision, in the program's place) fails one number or
more; and a whole run with each fault planted in the timed path, the look
for a card skipped, comes out ``correct: false``.  The program runs its
plain versions in float32 here; its kernels are held to them bitwise on
the card by the repository's own checks."""

from __future__ import annotations

import contextlib

import pytest
import torch
from small import small_cell

from portbench import catalog, control, faults, generator, harness

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
SEED = 2**31 + 101


def _quiet(s):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = harness.run(name, SEED, 0.3, False, "cpu", cell=small_cell(name), log=_quiet)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    for c in result["check"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_is_correct_and_reads(name):
    result = harness.run(name, SEED + 1, 0.3, True, "cpu", cell=small_cell(name), log=_quiet)
    assert result["correct"]
    assert "entry.host_ms" in result["metrics"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_a_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with faults.planted(cell["config"]["system"], fault):
        result = harness.run(name, SEED, 0.3, False, "cpu", cell=cell, log=_quiet)
    assert not result["correct"] and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_each_control_fails(name):
    cell = small_cell(name)
    module = catalog.system(cell["config"]["system"])
    system = module.System(cell["config"], cell["traffic"], SEED, "cpu")
    inp = generator.inputs(cell["traffic"], SEED, "cpu")[0]
    limits = cell["limits"]
    for kind in module.CONTROLS:
        numbers = system.check(inp, [system.control(inp, kind)])[0]
        assert any(numbers[n] > limits[n] for n in limits), (kind, numbers)
    sound = system.check(inp, [system.run(inp, lambda n: contextlib.nullcontext())])[0]
    assert all(sound[n] <= limits[n] for n in limits), sound


def test_control_readings_cover_every_variant():
    lines = []
    control.readings(small_cell("mbcn.30y"), [SEED], 1, "cpu", lines.append)
    module = catalog.system("mbcn")
    whats = [line["what"] for line in lines]
    assert whats == (["program"] + [f"control:{k}" for k in module.CONTROLS] + ["program_tf32"]
                     + [f"fault:{f}" for f in faults.FAULTS])
    summary = control.summary(lines)
    assert set(summary["program"]) == set(module.NUMBERS)


def test_control_readings_of_a_path_without_a_matrix_product():
    lines = []
    control.readings(small_cell("qm_detrend.30y"), [SEED], 1, "cpu", lines.append)
    assert [line["what"] for line in lines] == ["program", "control:bf16"] + [f"fault:{f}" for f in faults.FAULTS]


def test_series_out_of_order_fail_though_the_median_holds():
    """Days put out of order in a quarter of the series keep every margin
    and the median series; the tail of the rank gaps shows them."""
    cell = small_cell("mbcn.30y")
    system = catalog.system("mbcn").System(cell["config"], cell["traffic"], SEED, "cpu")
    inp = generator.inputs(cell["traffic"], SEED, "cpu")[0]
    with faults.planted("mbcn", "shuffled"):
        out = system.run(inp, lambda n: contextlib.nullcontext())
    numbers = system.check(inp, [out])[0]
    limits = cell["limits"]
    assert numbers["rank_gap"] <= limits["rank_gap"] and numbers["margin_gap"] <= limits["margin_gap"]
    assert any(numbers[n] > limits[n] for n in limits)


def test_nan_output_fails():
    cell = small_cell("qm_detrend.30y")
    system = catalog.system("quantile_mapper").System(cell["config"], cell["traffic"], SEED, "cpu")
    inp = generator.inputs(cell["traffic"], SEED, "cpu")[0]
    (out,) = system.run(inp, lambda n: contextlib.nullcontext())
    out = out.clone()
    out[1, 3] = float("nan")
    numbers = system.check(inp, [(out,)])[0]
    assert numbers["max_gap_K"] == float("inf")


def test_same_seed_same_inputs_other_seed_other_values():
    traffic = small_cell("mbcn.30y")["traffic"]
    a = generator.inputs(traffic, SEED, "cpu")
    b = generator.inputs(traffic, SEED, "cpu")
    c = generator.inputs(traffic, SEED + 1, "cpu")
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]) and a[0][k].shape == c[0][k].shape
        assert not torch.equal(a[0][k], c[0][k]) and not torch.equal(a[0][k], a[1][k])


def test_card_run_of_a_small_cell(card):
    """On a card: a small cell through the kernels, correct."""
    result = harness.run("mbcn.30y", SEED, 0.5, True, "cuda", cell=small_cell("mbcn.30y"), log=_quiet)
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
