"""The traced run's reading of ``torch.profiler``: what ran on the device
in the window, and what the host was doing while the device sat idle.

The window is the benchmark's own ``portbench.window`` range, so its
length and the device's activity come from one clock.  Busy time is the
union of every device activity (kernels, copies, sets) inside it.  The
raw events are read straight from the profiler's results, not through
its per-op tables, so that a window of a million events stays cheap.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

WINDOW = "portbench.window"
# Names of the host ranges the benchmark itself records around its calls.
SPAN_PREFIX = "portbench."
_WALK_BACK = 64


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float
    kernels: int
    device_ops: list  # [[name, seconds], ...] by total time, at most 10
    idle_gaps: list  # [[what the host was doing, seconds], ...], at most 10


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Union of intervals: (merged starts, merged ends)."""
    if starts.size == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    ms = s[new]
    idx = np.flatnonzero(new)
    me = run_end[np.r_[idx[1:] - 1, s.size - 1]]
    return ms, me


def _top(names, secs, k: int = 10) -> list:
    tot: dict = {}
    for n, v in zip(names, secs):
        tot[n] = tot.get(n, 0.0) + float(v)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def short(name: str, most: int = 160) -> str:
    """A device op's name without its argument list and namespaces that
    say nothing, at most ``most`` characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:most].strip()


def _annotation(ev, name: str) -> bool:
    """Whether a device-side event is a host range mirrored there (the
    profiler marks them where its version can say so)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    mark = getattr(ev, "is_user_annotation", None)
    if mark is not None:
        return bool(mark())
    return name.startswith(SPAN_PREFIX)


def read(prof) -> Trace:
    """The trace of the ``WINDOW`` range of a finished profiler."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, dev_n = [], [], []
    cpu_s, cpu_e, cpu_n, cpu_t = [], [], [], []
    win = None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == cuda:
            # A range recorded on the host shows on the device's timeline
            # too; it is no device activity.
            if _annotation(ev, name):
                continue
            dev_s.append(s)
            dev_e.append(e)
            dev_n.append(name)
        else:
            if name == WINDOW:
                win = (s, e, ev.start_thread_id())
            cpu_s.append(s)
            cpu_e.append(e)
            cpu_n.append(name)
            cpu_t.append(ev.start_thread_id())
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1, tid = win
    ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (de > w0) & (ds < w1)
    ds, de = np.clip(ds[inside], w0, w1), np.clip(de[inside], w0, w1)
    names = [n for n, k in zip(dev_n, inside) if k]
    ms, me = _merge(ds, de)
    busy = int((me - ms).sum())
    is_kernel = np.asarray([not _is_copy(n) for n in names], bool)
    kern = de[is_kernel] - ds[is_kernel]
    # Idle gaps inside the window, named by the host's innermost range or
    # op on the benchmark's thread at the gap's middle, under the
    # benchmark's own range around it.
    gs = np.r_[w0, me]
    ge = np.r_[ms, w1]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mine = np.asarray(cpu_t) == tid
    cs = np.asarray(cpu_s, np.int64)[mine]
    ce = np.asarray(cpu_e, np.int64)[mine]
    cn = [n for n, k in zip(cpu_n, mine) if k]
    o = np.argsort(cs, kind="stable")
    cs, ce, cn = cs[o], ce[o], [cn[i] for i in o]
    own = np.asarray([n.startswith(SPAN_PREFIX) for n in cn], bool)
    span = own & np.asarray([n != WINDOW for n in cn], bool)
    mid = (gs + ge) // 2
    labels = [_innermost(mid, cs, ce, cn, span), _innermost(mid, cs, ce, cn, ~own)]
    gap_names = [f"{a or 'host'}: {b or 'python'}" for a, b in zip(*labels)]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                 kernel_s=float(kern.sum()) * 1e-9, kernels=int(is_kernel.sum()),
                 device_ops=_top([short(n) for n in names], (de - ds) * 1e-9),
                 idle_gaps=_top(gap_names, (ge - gs) * 1e-9))


def _innermost(points, cs, ce, cn, sel) -> list:
    """For each point, the name of the latest-starting selected range that
    covers it (None if none within reach)."""
    cs, ce = cs[sel], ce[sel]
    cn = [n for n, k in zip(cn, sel) if k]
    out: list = [None] * len(points)
    if cs.size == 0:
        return out
    idx = np.searchsorted(cs, points, side="right") - 1
    todo = np.ones(len(points), bool)
    for k in range(_WALK_BACK):
        c = idx - k
        hit = todo & (c >= 0) & (ce[np.maximum(c, 0)] >= points)
        for p in np.flatnonzero(hit):
            out[p] = cn[c[p]]
        todo &= ~hit
        if not todo.any():
            break
    return out


@contextlib.contextmanager
def window(enabled: bool, cuda: bool):
    """The measured window, under ``torch.profiler`` when ``enabled``.
    Yields a holder whose ``trace`` is set once the window has closed."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
            if cuda:
                torch.cuda.synchronize()
    holder.trace = read(prof)


def span(name: str):
    """A host range of the benchmark's own, seen in the traced run."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
