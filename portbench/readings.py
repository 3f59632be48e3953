"""What a run recorded, and the arithmetic the metric readers share.

Each metric is a file of its own under ``metrics/``, whose ``read(run)``
returns a number, or None where the run holds nothing to read (the
harness then leaves the metric out of the line).  Never 0 for a share.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    kind: str  # "selfjoin" or "append"
    t0: float  # host clock, seconds
    t1: float
    n: int  # points of the series it computed on (selfjoin) or appended
    m: int
    dtype: str
    pairs: int = 0


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    setup_s: float
    window: tuple  # (start, end) on the host clock
    requests: list
    trace: object = None  # portbench.trace.Trace of the traced run
    counters: dict = dataclasses.field(default_factory=dict)

    def of(self, kind: str) -> list:
        return [r for r in self.requests if r.kind == kind]


def p95_ms(run: Run, kind: str):
    d = [(r.t1 - r.t0) * 1e3 for r in run.of(kind)]
    return float(np.percentile(d, 95)) if d else None


def idle_pct(run: Run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def per_append(run: Run, total: float):
    apps = run.of("append")
    t = run.trace
    if t is None or not apps or t.kernels == 0:
        return None
    return total / len(apps)
