"""The port's spans and host-wait counter (``utils/profiling.py``) on the
quantile-mapping and MBCn paths, on the CPU: under a ``torch.profiler``
every ``sdt.*`` span of a job appears, nested as the layers are, and the
record of ``recorded_spans`` counts each; with no profiler a span enters no
``record_function`` and records nothing; ``HOST_WAITS`` adds one a
copy from host memory, on a warm and on a cold table cache.  The card's
sync warnings are held to the same count in ``tests/test_torch_cuda.py``."""

import sys
from collections import Counter

import numpy as np
import pytest
import torch

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.utils.profiling as PP
from skdownscale_tpu_torch.models import batched, mbc
from skdownscale_tpu_torch.models import quantile as Q

ROTATIONS = 3


def _qm_job(fit_days, transform_days):
    rng = np.random.default_rng(3)
    fit = torch.from_numpy(283 + rng.normal(0, 4, (4, fit_days)))
    x = torch.from_numpy(284 + rng.normal(0, 4, (4, transform_days)))
    model = P.QuantileMapper(detrend=True)

    def job():
        state = batched.batched_fit(model, None, fit[..., None], None)
        return batched.batched_transform(model, state, None, x[..., None], None)

    return job


def _mbcn_job(days_obs_hist, days_fut, kinds):
    rng = np.random.default_rng(5)
    d = len(kinds)
    obs, hist = (torch.from_numpy(10 + rng.gamma(4, 1, (4, days_obs_hist, d))) for _ in range(2))
    fut = torch.from_numpy(11 + rng.gamma(4, 1, (4, days_fut, d)))
    rots = torch.from_numpy(mbc.mbcn_rotations(d, ROTATIONS, 7))

    def job():
        return mbc.mbcn_correct(obs, hist, fut, rots, kinds=kinds, extrapolate="both", n_endpoints=10)

    return job


JOBS = {
    "qm_tails": lambda: _qm_job(200, 300),  # the record reaches past the fit's plotting positions
    "qm_equal": lambda: _qm_job(300, 300),
    "mbcn": lambda: _mbcn_job(240, 240, ("difference",) * 3),
    "mbcn_two_kinds": lambda: _mbcn_job(240, 240, ("difference", "ratio", "difference")),
    "mbcn_fut_longer": lambda: _mbcn_job(240, 300, ("difference",) * 3),
}


def _clear_table_caches():
    Q._qm_tables.cache_clear()
    mbc._rank_bracket_dev.cache_clear()


def _profiled(job, monkeypatch):
    """``torch.profiler`` imports ``torch._dynamo``, which looks up the spec
    of ``xarray``; the suite's stand-in module for it (``tests/conftest.py``)
    has none, so it leaves while this runs."""
    stub = sys.modules.get("xarray")
    if stub is not None and stub.__spec__ is None:
        monkeypatch.delitem(sys.modules, "xarray")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        job()
    return prof


def _spans_with_parents(prof) -> Counter:
    """(span, its nearest enclosing span or None) of every ``sdt.*`` range."""
    out = Counter()
    for ev in prof.events():
        if not ev.name.startswith("sdt."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("sdt."):
            parent = parent.cpu_parent
        out[ev.name, parent.name if parent is not None else None] += 1
    return out


SPANS = {
    "qm_tails": {
        ("sdt.qm.fit", None): 1, ("sdt.qm.trend", "sdt.qm.fit"): 1, ("sdt.qm.sort", "sdt.qm.fit"): 1,
        ("sdt.qm.transform", None): 1, ("sdt.qm.trend", "sdt.qm.transform"): 2,
        ("sdt.qm.map", "sdt.qm.transform"): 1, ("sdt.wait.qm_tail", "sdt.qm.map"): 2,
    },
    "mbcn": {
        ("sdt.mbcn.correct", None): 1, ("sdt.mbcn.margins", "sdt.mbcn.correct"): 1,
        ("sdt.wait.mbcn_kinds", "sdt.mbcn.margins"): 1,
        ("sdt.mbcn.rotate", "sdt.mbcn.correct"): 2 * ROTATIONS,
        ("sdt.mbcn.rank", "sdt.mbcn.correct"): ROTATIONS,
        ("sdt.mbcn.interp", "sdt.mbcn.correct"): ROTATIONS,
        ("sdt.mbcn.reorder", "sdt.mbcn.correct"): 1, ("sdt.mbcn.rank", "sdt.mbcn.reorder"): 2,
    },
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_every_span_nested_as_the_layers(name, monkeypatch):
    job = JOBS[name]()
    job()  # warm the table caches: a cold job adds their copies' waits
    prof = _profiled(job, monkeypatch)
    assert _spans_with_parents(prof) == Counter(SPANS[name])


@pytest.mark.parametrize("name", sorted(SPANS))
def test_the_record_counts_every_span_of_the_stretch(name, monkeypatch):
    """Under a profiler the record holds each span's count and host time
    (no device time with no CUDA in use); a job with no profiler ends the
    stretch and leaves the record as it was, and the next profiled job
    starts it anew."""
    other = JOBS["mbcn" if name.startswith("qm") else "qm_tails"]()
    other()
    job = JOBS[name]()
    _profiled(other, monkeypatch)
    job()  # warms the table caches, and ends the stretch
    _profiled(job, monkeypatch)
    want = Counter()
    for (span, _), n in SPANS[name].items():
        want[span] += n
    record = PP.recorded_spans()
    assert {span: r["count"] for span, r in record.items()} == want
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in record.values())
    job()
    assert PP.recorded_spans() == record


@pytest.mark.parametrize("name", sorted(SPANS))
def test_no_record_function_without_a_profiler(name, monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a record_function range with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert PP.annotate("sdt.a") is PP.annotate("sdt.b")
    before = sum(PP.HOST_WAITS.values())
    JOBS[name]()()
    assert sum(PP.HOST_WAITS.values()) > before  # the counter counts with no profiler


# waits a job adds to HOST_WAITS, by site, on a warm table cache and on a cold one
WAITS = [
    ("qm_tails", "warm", {"qm_tail": 2}),
    ("qm_equal", "warm", {}),
    ("mbcn", "warm", {"mbcn_kinds": 1}),
    ("mbcn_two_kinds", "warm", {"mbcn_kinds": 2}),
    # hist and obs of one length, fut longer: fut's margins take the bracket plan, x and y alike
    ("mbcn_fut_longer", "warm", {"mbcn_kinds": 1, "qdm_brackets": 10}),
    ("qm_tails", "cold", {"qm_tables": 8, "qm_tail": 2}),
    ("qm_equal", "cold", {"qm_tables": 8}),
    ("mbcn", "cold", {"mbcn_brackets": 3, "mbcn_kinds": 1}),
]


@pytest.mark.parametrize("name,cache,want", WAITS)
def test_host_waits_a_job(name, cache, want):
    job = JOBS[name]()
    job()
    if cache == "cold":
        _clear_table_caches()
    before = Counter(PP.HOST_WAITS)
    job()
    grew = Counter(PP.HOST_WAITS)
    grew.subtract(before)
    assert +grew == Counter(want)


def test_rounds_lay_out_their_rows_inside_the_rotation(monkeypatch):
    """Each round hands K9 and K6 rows already laid out as rows, so their
    transposing copies run in ``sdt.mbcn.rotate``, not in the kernels' spans."""
    handed = []

    def recorded(fn):
        def call(*args):
            handed.extend(a.is_contiguous() for a in args if isinstance(a, torch.Tensor))
            return fn(*args)

        return call

    monkeypatch.setattr(mbc, "on_rows", recorded(mbc.on_rows))
    monkeypatch.setattr(mbc, "interp_rows", recorded(mbc.interp_rows))
    rng = np.random.default_rng(9)
    obs, mh, mf = (torch.from_numpy(10 + rng.gamma(4, 1, shape)) for shape in ((4, 240, 3), (4, 3, 240), (4, 3, 300)))
    lo, hi, w = mbc._rank_bracket_dev(240, 240, 0.4, 0.4, obs.device, obs.dtype)
    rots = torch.from_numpy(mbc.mbcn_rotations(3, ROTATIONS, 7))
    mbc.mbcn_iterate(obs, mh, mf, rots, lo, hi, w)
    assert len(handed) == 7 * ROTATIONS and all(handed)
