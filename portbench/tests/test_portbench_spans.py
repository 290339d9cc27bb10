"""The program's spans and host waits as the benchmark reads them: each
new reader on a made-up record of the program's spans, silent where the
program keeps no record or no device time, a CPU traced run of each small
cell, and ``trace.read`` on a timeline that holds the program's spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from small import small_cell

import skdownscale_tpu_torch.utils.profiling as PP
from portbench import catalog, harness
from portbench import trace as trace_reader

SEED = 2**31 + 307


class _Ev:
    def __init__(self, name, device, start_us, dur_us, annotation=False):
        self._n, self._d, self._s, self._t = name, device, start_us, dur_us
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._t * 1000)

    def is_user_annotation(self):
        return self._a


def _timeline():
    """A window of 100 us: a transform whose map waits on a copy from the
    host (20..30) and launches a kernel from inside the range itself, a
    trend range, and a kernel launched outside every span."""
    return [
        _Ev("portbench.window", "CPU", 0, 100, annotation=True),
        _Ev("sdt.qm.transform", "CPU", 0, 60, annotation=True),
        _Ev("sdt.qm.transform", "CUDA", 22, 33, annotation=True),  # the GPU side: no device time
        _Ev("sdt.qm.map", "CPU", 10, 40, annotation=True),
        _Ev("sdt.wait.qm_tail", "CPU", 20, 10, annotation=True),
        _Ev("aten::copy_", "CPU", 21, 8),
        _Ev("cudaMemcpyAsync", "CPU", 22, 1),
        _Ev("cudaStreamSynchronize", "CPU", 23, 6),
        _Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 22, 2),
        _Ev("aten::add", "CPU", 40, 1),
        _Ev("cudaLaunchKernel", "CPU", 40.5, 0.2),
        _Ev("add_kernel(float)", "CUDA", 41, 9),
        # a kernel a library launches through ctypes: no operator around it
        _Ev("cudaLaunchKernel", "CPU", 45, 1),
        _Ev("rank_map_block_kernel(float)", "CUDA", 50, 5),
        _Ev("sdt.qm.trend", "CPU", 60, 10, annotation=True),
        _Ev("aten::mul", "CPU", 61, 1),
        _Ev("cudaLaunchKernel", "CPU", 61.5, 0.2),
        _Ev("mul_kernel(float)", "CUDA", 62, 4),
        _Ev("cudaLaunchKernel", "CPU", 65, 0.2),
        _Ev("fill_kernel(float)", "CUDA", 66, 2),
        _Ev("scale_kernel(float)", "CUDA", 68, 1),
        _Ev("cudaLaunchKernel", "CPU", 79, 0.2),
        _Ev("aten::sum", "CPU", 78.5, 1),
        _Ev("sum_kernel(float)", "CUDA", 80, 10),  # outside every span
    ]


def test_trace_read_is_unchanged_by_the_program_spans():
    """The breakdown and the existing metrics on a timeline with the
    program's ranges, host and device sides: as ``trace.read`` reads it."""
    events = _timeline()
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    r = trace_reader.read(prof)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((2 + 9 + 5 + 4 + 2 + 1 + 10) * 1e-6)
    assert r["kernel_s"] == {k: pytest.approx(v) for k, v in {
        "Memcpy HtoD (Pageable -> Device)": 2e-6, "add_kernel": 9e-6, "rank_map_block_kernel": 5e-6,
        "mul_kernel": 4e-6, "fill_kernel": 2e-6, "scale_kernel": 1e-6, "sum_kernel": 10e-6}.items()}
    gaps = [[label, pytest.approx(s)] for label, s in r["idle_gaps"]]
    # the two innermost host events at each gap's start, the program's ranges among them
    assert gaps == [["outside a job / sdt.qm.transform", 22e-6],
                    ["outside a job / aten::copy_ / cudaStreamSynchronize", 17e-6],
                    ["outside a job / sdt.qm.trend", 11e-6],
                    ["outside a job", 10e-6],
                    ["outside a job / sdt.qm.transform", 7e-6]]


RECORD = {
    "sdt.qm.trend": {"device_ms": 30.0, "host_ms": 1.0, "count": 6},
    "sdt.qm.sort": {"device_ms": 20.0, "host_ms": 0.5, "count": 2},
    "sdt.qm.map": {"device_ms": 40.0, "host_ms": 2.0, "count": 2},
    "sdt.mbcn.margins": {"device_ms": 50.0, "host_ms": 1.0, "count": 2},
    "sdt.mbcn.rotate": {"device_ms": 240.0, "host_ms": 4.0, "count": 80},
    "sdt.mbcn.rank": {"device_ms": 160.0, "host_ms": 8.0, "count": 44},
    "sdt.mbcn.interp": {"device_ms": 220.0, "host_ms": 2.0, "count": 40},
    "sdt.wait.qm_tail": {"device_ms": 0.01, "host_ms": 3.0, "count": 4},
    "sdt.wait.mbcn_kinds": {"device_ms": 0.01, "host_ms": 1.0, "count": 2},
}

NEW = {
    "qm.trend_ms": 15.0, "qm.sort_ms": 10.0, "qm.map_ms": 20.0, "mbcn.margins_ms": 25.0,
    "mbcn.rotate_ms": 120.0, "mbcn.rank_ms": 80.0, "mbcn.interp_ms": 110.0,
    "host.waits": 3.0, "host.wait_ms": 2.0,
}
WAIT_METRICS = {"host.waits", "host.wait_ms"}


def _read(name, monkeypatch, record):
    """The reader of ``name`` on a window of two jobs whose spans the
    program recorded as ``record``."""
    monkeypatch.setattr(PP, "recorded_spans", lambda: record, raising=False)
    return catalog.metric_reader(name)(SimpleNamespace(jobs=2))


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_made_up_window(name, monkeypatch):
    assert _read(name, monkeypatch, RECORD) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_is_silent_on_a_program_without_the_record(name, monkeypatch):
    """The parent of this benchmark's spans (no ``recorded_spans``), and a
    program whose spans did not run while the profiler recorded."""
    monkeypatch.delattr(PP, "recorded_spans")
    assert catalog.metric_reader(name)(SimpleNamespace(jobs=2)) is None
    assert _read(name, monkeypatch, {}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_off_the_card(name, monkeypatch):
    """Spans recorded with no CUDA in use carry no device time: no device
    metric reads; the waits read, 0 where no span waited."""
    host_only = {n: {**s, "device_ms": None} for n, s in RECORD.items() if not n.startswith("sdt.wait.")}
    value = _read(name, monkeypatch, host_only)
    assert value == (0.0 if name in WAIT_METRICS else None)


def test_every_new_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in catalog.benchmark()["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_span" and entries[name]["moves"] == "cells_per_s"


# the host waits a job of each small cell on the CPU: the QM cells fit and
# transform records of one length at the small size (no tail); MBCn's
# margins make one index copy for their one kind
SMALL_WAITS = {"qm_detrend.1950-2100": 0.0, "qm_detrend.30y": 0.0, "mbcn.30y": 1.0}


@pytest.mark.parametrize("name", sorted(SMALL_WAITS))
def test_cpu_traced_run_reports_the_waits(name):
    result = harness.run(name, SEED, 0.3, True, "cpu", cell=small_cell(name), log=lambda s: None)
    metrics = result["metrics"]
    assert result["correct"]
    assert metrics["host.waits"]["value"] == SMALL_WAITS[name]
    assert metrics["host.wait_ms"]["value"] >= 0.0
    # no device on the CPU: no device time is reported under a device metric
    assert not {"qm.trend_ms", "mbcn.rotate_ms"} & set(metrics)
