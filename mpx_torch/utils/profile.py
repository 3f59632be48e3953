"""Per-phase benchmark profile, counterpart of ``mpx/utils/profile.py``.

Accumulates named timings into categories and renders a percentage
report.  Device work is asynchronous, so :func:`phase` synchronizes the
CUDA device at both phase boundaries: each phase's time is the card's
time for that phase, not the enqueue time.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from mpx_torch.utils.timer import Timer


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
def phase(profile: "BenchmarkProfile | None", category: str, device=None):
    """Time a phase into ``profile`` (no-op when profile is None).  On a
    CUDA ``device`` the device is synchronized before the clock starts and
    before it stops."""
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
