"""The port's tracing: per-phase profiles, spans and counters.

:class:`BenchmarkProfile` (counterpart of ``mpx/utils/profile.py``)
accumulates named timings into categories and renders a percentage
report.  Device work is asynchronous, so :func:`phase` synchronizes the
CUDA device at both phase boundaries: each phase's time is the card's
time for that phase, not the enqueue time.

:func:`span` marks a layer of a call (``mpx_torch.<name>``) while a
``torch.profiler`` session records, and only then: the range stands on
the profiler's timeline beside the kernels it launches, and a record of
it (:class:`SpanRecord`, on ``time.perf_counter_ns``'s clock) is kept in
memory for :func:`spans`.  Outside a profiler a span is one check and a
shared no-op context.  :func:`count` adds to a process-wide registry of
counters (kernel launches, K3's batches that sum row segments first, K3's
jobs, plain-version calls, the append's copies),
always on; :func:`counters` returns a snapshot of it, and two snapshots'
difference is what ran between them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from mpx_torch.utils.timer import Timer

# Prefix of every span's range name.
SPAN_PREFIX = "mpx_torch."
# Records kept: the newest, a ring; each one dropped from it is counted
# under ``spans.dropped``.
MAX_SPANS = 1 << 17

_NOOP = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
# The profiler's range: its C++ form where this torch has it (a tenth of
# ``record_function``'s cost), the same event in the trace.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.autograd.profiler.record_function
_COUNTS: dict = {}
_COUNTS_LOCK = threading.Lock()
_RECORDS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the process-wide counter ``name``."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + k


def counters() -> collections.Counter:
    """A snapshot of every counter (a ``Counter``: 0 for a name never
    counted)."""
    with _COUNTS_LOCK:
        return collections.Counter(_COUNTS)


class SpanRecord(NamedTuple):
    id: int
    name: str  # the range's name, ``mpx_torch.<name>``
    parent: int  # the enclosing span's id, 0 for a root
    root: int  # the root's id, shared by every span of one call
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    counters: collections.Counter  # what the registry counted inside it


def spans() -> list:
    """The kept span records (:class:`SpanRecord`), oldest first."""
    return list(_RECORDS)


class _Span:
    __slots__ = ("name", "id", "parent", "root", "_range", "_before", "_t0")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else 0
        self.root = outer.root if outer else self.id
        stack.append(self)
        # dict.copy is one C call, whole under the GIL; the record's stamps
        # enclose the range's own.
        self._before = _COUNTS.copy()
        self._range = _Range(self.name)
        self._t0 = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        before, delta = self._before, collections.Counter()
        for k, v in _COUNTS.copy().items():
            if v != before.get(k, 0):
                delta[k] = v - before.get(k, 0)
        _OPEN.stack.pop()
        if len(_RECORDS) == _RECORDS.maxlen:
            count("spans.dropped")
        _RECORDS.append(SpanRecord(self.id, self.name, self.parent, self.root,
                                   self._t0, t1, delta))
        return False


def span(name: str):
    """A context that marks ``mpx_torch.<name>`` while a ``torch.profiler``
    session records (a ``record_function`` range and a :class:`SpanRecord`
    with its parent, root and counter deltas); otherwise a shared no-op."""
    if not _recording():
        return _NOOP
    return _Span(name)


_open_span = span  # phase() takes a parameter of this name


class BenchmarkProfile:
    def __init__(self):
        # category -> OrderedDict(name -> ns)
        self._categories: "OrderedDict[str, OrderedDict[str, int]]" = OrderedDict()
        # What a run counted (e.g. the hybrid's flags per job and escalated
        # rows), by name; filled by the code that runs, shown by report().
        self.counts: "OrderedDict[str, float]" = OrderedDict()

    def push(self, category: str, ns: int, name: str | None = None):
        entries = self._categories.setdefault(category, OrderedDict())
        key = name if name is not None else f"#{len(entries)}"
        entries[key] = entries.get(key, 0) + ns

    def total(self) -> int:
        return sum(sum(e.values()) for e in self._categories.values())

    def category_totals(self) -> "OrderedDict[str, int]":
        return OrderedDict(
            (cat, sum(entries.values())) for cat, entries in self._categories.items()
        )

    def report(self, file=None) -> str:
        """Category totals with percentages, plus per-entry lines for
        categories with named or repeated entries."""
        total = max(self.total(), 1)
        lines = ["Benchmark profile:"]
        for cat, entries in self._categories.items():
            cat_ns = sum(entries.values())
            lines.append(
                f"  {cat}: {Timer.pretty(cat_ns)} ({100.0 * cat_ns / total:.2f}%)"
            )
            if len(entries) > 1 or any(not k.startswith("#") for k in entries):
                denom = max(cat_ns, 1)
                for name, ns in entries.items():
                    lines.append(
                        f"    {name}: {Timer.pretty(ns)} "
                        f"({100.0 * ns / denom:.2f}%)"
                    )
        lines.append(f"  Total: {Timer.pretty(self.total())}")
        lines += [f"  {name}: {value}" for name, value in self.counts.items()]
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text


@contextlib.contextmanager
def phase(profile: "BenchmarkProfile | None", category: str, device=None,
          span: str | None = None):
    """Time a phase into ``profile`` (no-op when profile is None).  On a
    CUDA ``device`` the device is synchronized before the clock starts and
    before it stops.  A ``span`` name also opens that :func:`span` around
    the phase, with or without a profile."""
    with _NOOP if span is None else _open_span(span):
        if profile is None:
            yield
            return
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t = Timer()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            profile.push(category, t.elapsed())
