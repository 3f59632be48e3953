"""The port's tracing on the CPU: spans only while a profiler records,
their nesting, roots and counter deltas in a self-join and a live feed,
the same ranges in the profiler's events, ``phase`` with a profile, the
registry's snapshots, and the benchmark's five readers of the spans."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpx_torch import MatrixProfileConfig, matrix_profile
from mpx_torch.config import make_job_grid
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.streaming import StreamingMatrixProfile
from mpx_torch.utils import profile as tracing
from mpx_torch.utils.profile import BenchmarkProfile, count, counters, phase, span, spans

N, M = 1024, 32
LAUNCHES = ("launches.k1", "launches.k3", "launches.window_stats")


def _walk(n=N, seed=0):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _recorded(fn):
    """(what ``fn`` returned, the span records it left, the profiler)."""
    last = max((s.id for s in spans()), default=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [s for s in spans() if s.id > last], prof


def _named(recs, name):
    return [s for s in recs if s.name == "mpx_torch." + name]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns and child.end_ns <= parent.end_ns


def test_span_without_a_profiler_records_nothing():
    assert not torch.autograd._profiler_enabled()
    last = max((s.id for s in spans()), default=0)
    assert span("matrix_profile") is span("append") is tracing._NOOP
    matrix_profile(_walk(), M, dtype="float64", device="cpu")
    smp = StreamingMatrixProfile(_walk(), M, "float64", device="cpu")
    smp.append([0.5])
    smp.row_values(smp._w - 1, smp._w)
    assert [s for s in spans() if s.id > last] == []


def test_self_join_spans_nest_under_one_root():
    T = _walk()
    w = N - M + 1
    (MP, MPI), recs, _ = _recorded(
        lambda: matrix_profile(T, M, dtype="float64", device="cpu"))
    assert MP.shape == (w,) and MPI.shape == (w,)
    assert sorted(s.name.removeprefix("mpx_torch.") for s in recs) == sorted(
        ["matrix_profile", "statistics", "statistics.host", "statistics.stage", "jobs", "post"])
    (root,) = _named(recs, "matrix_profile")
    assert root.parent == 0 and {s.root for s in recs} == {root.id}
    (stats,) = _named(recs, "statistics")
    for name, parent in (("statistics", root), ("jobs", root), ("post", root),
                         ("statistics.host", stats), ("statistics.stage", stats)):
        (s,) = _named(recs, name)
        assert s.parent == parent.id and _inside(s, parent), name
    cfg = MatrixProfileConfig(m=M, dtype="float64", device="cpu").shrink_to(w)
    jobs = len(make_job_grid(w, cfg.band, cfg.chunk).r0)
    (loop,) = _named(recs, "jobs")
    assert root.counters["calls.mxu"] == loop.counters["calls.mxu"] == jobs
    assert sum(root.counters[k] for k in LAUNCHES) == 0  # the plain path on the CPU


def test_k3_batches_have_a_span_each(monkeypatch):
    """The recurrence's batched loop (``kernel='pallas'``, the plain sweep on
    the CPU) marks each batch with a ``jobs.batch`` span inside ``jobs``,
    counting its jobs' plain calls; the ranges are in the profiler's events."""
    from mpx_torch.kernels import recurrence

    monkeypatch.setattr(recurrence, "BATCH_JOBS", 2)
    T = _walk()
    w = N - M + 1
    cfg = MatrixProfileConfig(m=M, dtype="float64", kernel="pallas", band=128, chunk=256,
                              device="cpu")
    _, recs, prof = _recorded(lambda: matrix_profile(T, M, dtype="float64", kernel="pallas",
                                                     band=128, chunk=256, device="cpu"))
    grid = make_job_grid(w, cfg.band, cfg.chunk)
    batches = recurrence.job_batches(len(grid.r0), 2)
    (loop,) = _named(recs, "jobs")
    spans_ = _named(recs, "jobs.batch")
    assert len(spans_) == len(batches) < len(grid.r0)
    assert [s.counters["calls.xla"] for s in spans_] == [b - a for a, b in batches]
    assert all(s.parent == loop.id and _inside(s, loop) for s in spans_)
    assert sum(root.counters[k] for root in _named(recs, "matrix_profile")
               for k in LAUNCHES) == 0  # the plain path on the CPU
    assert "mpx_torch.jobs.batch" in {e.name for e in prof.events()}


@pytest.mark.parametrize("backend, children", [
    ("numpy", ["host", "stage"]),
    ("device", ["host", "window_sums", "host", "stage"]),  # the kernel's plain version
])
def test_statistics_spans_split_host_and_device_work(backend, children):
    T = _walk()
    stats, recs, _ = _recorded(lambda: precompute_statistics(
        T, M, band=256, chunk=512, dtype="float64", device="cpu", backend=backend))
    assert stats.windows is not None
    got = sorted(recs, key=lambda s: s.start_ns)
    assert [s.name for s in got] == ["mpx_torch.statistics." + c for c in children]
    assert all(s.parent == 0 and s.root == s.id for s in got)


def test_append_spans_and_copies():
    smp = StreamingMatrixProfile(_walk(1000), M, "float64", device="cpu")

    def feed():
        reads = []
        for k in (1, 1, 60, 1):  # the third passes the capacity of 1024 windows
            smp.append(_walk(k, seed=k + 7) + 3.0)
            reads.append(smp.row_values(smp._w - k, smp._w))
        return reads

    reads, recs, _ = _recorded(feed)
    assert [r.shape[0] for r in reads] == [1, 1, 60, 1]
    appends, backs = _named(recs, "append"), _named(recs, "row_values")
    assert len(appends) == len(backs) == 4
    for a, b in zip(appends, backs):
        assert a.parent == b.parent == 0 and a.root == a.id and b.root == b.id
        assert a.end_ns <= b.start_ns
        kids = sorted((s for s in recs if s.parent == a.id), key=lambda s: s.start_ns)
        assert all(s.root == a.id and _inside(s, a) for s in kids)
        names = [s.name.removeprefix("mpx_torch.append.") for s in kids]
        grew = a is appends[2]
        assert names == ["stats"] + ["grow"] * grew + ["stage", "sweep", "merge"]
        assert dict(a.counters) == {"copies.append_h2d": 3}
        assert dict(b.counters) == {"copies.append_d2h": 1}
    assert smp.capacity_doublings == 1


def test_spans_are_the_profilers_ranges():
    """Each record is a ``record_function`` range of its name; the record
    is stamped just outside the range, so it is a few us longer."""
    T = _walk()
    smp = StreamingMatrixProfile(_walk(), M, "float64", device="cpu")

    def calls():
        matrix_profile(T, M, dtype="float64", device="cpu")
        for i in range(8):
            smp.append([float(i)])
            smp.row_values(smp._w - 1, smp._w)

    _, recs, prof = _recorded(calls)
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("mpx_torch."):
            ranges[e.name].append(e.time_range)
    mine = collections.defaultdict(list)
    for s in recs:
        mine[s.name].append(s)
    assert set(ranges) == set(mine)
    diffs = []
    for name, rs in ranges.items():
        rs = sorted(rs, key=lambda r: r.start)
        ss = sorted(mine[name], key=lambda s: s.start_ns)
        assert len(rs) == len(ss), name
        diffs += [(s.end_ns - s.start_ns) * 1e-3 - (r.end - r.start) for r, s in zip(rs, ss)]
    assert min(diffs) >= -5.0
    assert np.median(diffs) <= 20.0


def test_phase_with_a_profile_reports_and_synchronizes(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    prof = BenchmarkProfile()
    with phase(prof, "1. Pre-Computation", device="cuda", span="statistics"):
        pass
    assert len(synced) == 2 and "1. Pre-Computation" in prof.report()
    assert list(prof.category_totals()) == ["1. Pre-Computation"]

    def traced():
        with phase(prof, "2. Compute", device="cpu", span="jobs"):
            pass
        with phase(None, "3. Post", span="post"):
            pass
        with phase(None, "4. Other"):
            pass

    _, recs, _ = _recorded(traced)
    assert [s.name for s in recs] == ["mpx_torch.jobs", "mpx_torch.post"]
    assert len(synced) == 2 and list(prof.category_totals())[-1] == "2. Compute"


def test_counters_are_snapshots():
    before = counters()
    count("tests.trace", 2)
    count("tests.trace")
    after = counters()
    assert after["tests.trace"] - before["tests.trace"] == 3
    assert after["tests.never_counted"] == 0
    after["tests.trace"] = -1
    assert counters()["tests.trace"] == before["tests.trace"] + 3
    assert (after - before)["launches.k1"] == 0


def test_records_are_a_ring_that_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_RECORDS", collections.deque(maxlen=4))
    dropped = counters()["spans.dropped"]

    def six():
        for i in range(6):
            with span(f"tests.ring.{i}"):
                pass

    _recorded(six)
    assert [s.name for s in spans()] == [f"mpx_torch.tests.ring.{i}" for i in range(2, 6)]
    assert counters()["spans.dropped"] - dropped == 2


@pytest.mark.parametrize("workload, expect", [
    ("showcase-f64.selfjoin", {"stats_ms.selfjoin": "positive", "kernel_launches.selfjoin": 0.0}),
    ("showcase-f64.append", {"append_host_us": "positive", "append_wait_us": "positive",
                             "append_copies": 4.0}),
])
def test_traced_rehearsal_reads_the_program_spans(monkeypatch, workload, expect):
    """The benchmark's readers of the program's spans, through the
    harness's whole traced run at tiny sizes.  On the CPU nothing runs on
    a device, so they read nothing; with a trace in which the device
    worked they read the spans of the window."""
    from portbench import trace
    from portbench.tests.tiny import rehearse

    plain = rehearse(workload, trace=True)
    assert plain["correct"] and not set(expect) & set(plain["metrics"])
    read = trace.read
    monkeypatch.setattr(trace, "read",
                        lambda prof: dataclasses.replace(read(prof), busy_s=1e-3))
    r = rehearse(workload, trace=True)
    assert r["correct"]
    for name, want in expect.items():
        got = r["metrics"][name]["value"]
        assert got > 0 if want == "positive" else got == want, (name, got)
