"""Each kernel's operations and bytes worked by hand at a small shape, the
roofline share from a made-up window, the launches recorded against the
calls the program makes, and the trace's reading of a made-up timeline."""

from __future__ import annotations

import contextlib
import importlib
from collections import Counter
from types import SimpleNamespace
from unittest import mock

import pytest

from portbench import catalog, generator, roofline
from portbench import trace as trace_reader
from portbench.roofline import k2, k6, k9


def test_k2_by_hand():
    # 3 segments of 5: 15 queries, 15 table entries, 15 outputs, 4 bytes each
    assert k2.cost(rows=3, L=5) == (0.0, 180.0)


def test_k9_by_hand():
    # 2 rows of 7: 14 keys in and out (112); with int32 positions out (168);
    # the unsort reads values and positions and writes values (168)
    assert k9.cost(form="sort", rows=2, L=7) == (0.0, 112.0)
    assert k9.cost(form="sort_positions", rows=2, L=7) == (0.0, 168.0)
    assert k9.cost(form="unsort", rows=2, L=7) == (0.0, 168.0)


def test_k6_by_hand():
    # 2 tables of 5 knots (xp, fp: 80 bytes) and 2 rows of 3 queries (24 in,
    # 24 out); 4 operations a query
    assert k6.cost(table_rows=2, query_rows=2, L=5, Q=3) == (24.0, 128.0)
    # one table shared by 2 query rows: the table read once (40 bytes)
    assert k6.cost(table_rows=1, query_rows=2, L=5, Q=3) == (24.0, 88.0)


def test_bound_takes_the_larger():
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def _ctx(**kw):
    base = dict(launch_shapes={"k2": [{"rows": 1000, "L": 10_000}] * 4},
                kernel_s={"staged_search_kernel": 1e-3, "sort_chunks_kernel": 1e-3, "other_kernel": 5.0})
    base.update(kw)
    return SimpleNamespace(**base)


def test_share_from_a_window():
    # 4 launches of 1e7 elements, 12 bytes each: 4.8e8 bytes, 1.4328e-4 s at
    # 3.35 TB/s, against 2 ms of K2's functions
    assert roofline.share(_ctx(), "k2") == pytest.approx(100 * 4.8e8 / 3.35e12 / 2e-3)


def test_share_is_silent_where_it_cannot_read():
    assert roofline.share(_ctx(kernel_s={"other_kernel": 1.0}), "k2") is None
    assert roofline.share(_ctx(launch_shapes={}), "k2") is None
    assert roofline.share(_ctx(launch_shapes=None), "k2") is None


def test_every_kernel_file_is_found():
    assert catalog.roofline_kernels() == ["k2", "k6", "k9"]


@contextlib.contextmanager
def on_the_kernel_path(calls):
    """The program's kernel wrappers take their kernel path on the CPU: each
    one-launch function runs the plain version, and each wrapper call is
    counted with its shape in ``calls`` (as ``recording`` should see it)."""
    from skdownscale_tpu_torch.kernels import interp, rank_map, sort_rows

    def spied(fn, key):
        def spy(*args):
            calls[key(*args)] += 1
            return fn(*args)
        return spy

    def plain_sort(lib, x, with_positions):
        return sort_rows.sort_rows_with_positions_plain(x) if with_positions else sort_rows.sort_rows_plain(x)

    patches = {
        sort_rows: dict(launch_sort=plain_sort, launch_unsort=lambda lib, v, p: sort_rows.unsort_rows_plain(v, p),
                        sort_route=lambda *a: "cpu", unsort_route=lambda *a: "cpu"),
        rank_map: dict(launch_rank_map=lambda lib, xq, res, L: rank_map.rank_map_segments_plain(xq, res, L)),
        interp: dict(launch=lambda lib, xp, fp, q: interp.batched_interp_plain(xp, fp, q)),
    }
    wrappers = {
        sort_rows: dict(sort_rows=lambda x: ("k9", "sort", *x.shape),
                        sort_rows_with_positions=lambda x: ("k9", "sort_positions", *x.shape),
                        unsort_rows=lambda v, p: ("k9", "unsort", *v.shape)),
        rank_map: dict(rank_map_segments=lambda xq, res, L: ("k2", xq.numel() // L, L)),
        interp: dict(batched_interp=lambda xp, fp, q: ("k6", xp.shape[0], q.shape[0], xp.shape[1], q.shape[1])),
    }
    with contextlib.ExitStack() as stack:
        for module, fns in patches.items():
            stack.enter_context(mock.patch.object(module, "on_kernel", lambda *ts: True))
            stack.enter_context(mock.patch.object(module, "_lib", lambda: None))
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(module, name, fn))
        # the callers bound the wrappers at import: spy on them where they are called
        from skdownscale_tpu_torch.models import grouped, mbc
        ops_interp = importlib.import_module("skdownscale_tpu_torch.ops.interp")
        for module, fns in wrappers.items():
            for name, key in fns.items():
                wrapper = getattr(module, name)
                for caller in (module, grouped, mbc, ops_interp):
                    if getattr(caller, name, None) is wrapper:
                        stack.enter_context(mock.patch.object(caller, name, spied(wrapper, key)))
        yield


def _keys(shapes):
    keys = Counter()
    for s in shapes.get("k9", []):
        keys["k9", s["form"], s["rows"], s["L"]] += 1
    for s in shapes.get("k2", []):
        keys["k2", s["rows"], s["L"]] += 1
    for s in shapes.get("k6", []):
        keys["k6", s["table_rows"], s["query_rows"], s["L"], s["Q"]] += 1
    return keys


@pytest.mark.parametrize("name", ["qm_detrend.1950-2100", "mbcn.30y", "qm_detrend.30y"])
def test_recording_sees_every_launch_with_its_shape(name):
    from small import small_cell
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.kernels.sort_rows import ROUTE_LAUNCHES

    cell = small_cell(name)
    system = catalog.system(cell["config"]["system"]).System(cell["config"], cell["traffic"], 9, "cpu")
    inp = generator.inputs(cell["traffic"], 9, "cpu")[0]
    calls, shapes = Counter(), {}
    saved = Counter(LAUNCHES), Counter(ROUTE_LAUNCHES)
    try:
        with on_the_kernel_path(calls), roofline.recording(catalog.roofline_kernels(), shapes):
            system.run(inp, lambda n: contextlib.nullcontext())
    finally:
        for counter, before in zip((LAUNCHES, ROUTE_LAUNCHES), saved):
            counter.clear()
            counter.update(before)
    assert calls and _keys(shapes) == calls


class _Ev:
    def __init__(self, name, device, start_us, dur_us):
        self._n, self._d, self._s, self._t = name, device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._t * 1000)

    def is_user_annotation(self):
        return False


def test_trace_reading_by_hand():
    k = "void (anonymous namespace)::sort_rows_smem_kernel<32, 12, true, false>(float const*, float*, int*, int, int)"
    events = [
        _Ev("portbench.window", "CPU", 0, 100),
        _Ev("portbench.mbcn.correct", "CPU", 0, 88),
        _Ev("aten::nonzero", "CPU", 30, 15),
        _Ev("cudaStreamSynchronize", "CPU", 34, 2),
        _Ev("portbench.mbcn.correct", "CUDA", 0, 90),  # the GPU side of a span: not busy time
        _Ev(k, "CUDA", 5, 10),
        _Ev(k, "CUDA", 10, 10),  # overlaps the first: busy 5..20
        _Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 30, 5),
        _Ev("void at::native::elementwise_kernel<128, 2>(int)", "CUDA", 60, 30),
        _Ev("late_kernel(int)", "CUDA", 95, 20),  # cut at the window's end
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    r = trace_reader.read(prof)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((15 + 5 + 30 + 5) * 1e-6)
    assert r["kernel_s"]["sort_rows_smem_kernel"] == pytest.approx(20e-6)
    assert r["kernel_s"]["late_kernel"] == pytest.approx(5e-6)
    gaps = [[label, pytest.approx(s)] for label, s in r["idle_gaps"]]
    assert gaps == [["mbcn.correct / aten::nonzero / cudaStreamSynchronize", 25e-6], ["mbcn.correct", 10e-6],
                    ["mbcn.correct", 5e-6], ["outside a job", 5e-6]]
    assert [n for n, _ in r["device_ops"]][0].startswith("void at::native::elementwise_kernel")


def test_function_names():
    assert trace_reader.function_name("void (anonymous namespace)::rank_map_block_kernel<12>(float const*)") \
        == "rank_map_block_kernel"
    assert trace_reader.function_name("staged_search_kernel(float const*, int)") == "staged_search_kernel"
    assert trace_reader.function_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD (Device -> Device)"


def test_trace_without_a_window_reads_nothing():
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: [])))
    assert trace_reader.read(prof) is None
