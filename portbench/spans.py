"""The program's own trace: the span records that ``mpx_torch.utils.profile``
keeps while a profiler records (the traced run's window), each with the
counters the program counted inside it, for the metrics that read them."""

from __future__ import annotations

PREFIX = "mpx_torch."


def in_window(run):
    """The program's span records that started and ended inside the traced
    window, or None where there is nothing to read: an untraced run, a run
    in which nothing ran on the device (the CPU's rehearsal), or a program
    that keeps no spans."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    try:
        from mpx_torch.utils.profile import spans
    except ImportError:
        return None
    w0, w1 = (round(x * 1e9) for x in run.window)
    return [s for s in spans() if s.start_ns >= w0 and s.end_ns <= w1]


def named(records, name: str) -> list:
    return [s for s in records or () if s.name == PREFIX + name]


def mean_us(run, name: str):
    """Mean duration of the window's ``mpx_torch.<name>`` spans, in us."""
    found = named(in_window(run), name)
    return sum(s.end_ns - s.start_ns for s in found) / len(found) * 1e-3 if found else None


def counted(records, names) -> int:
    """The counters ``names`` summed over ``records``."""
    return sum(s.counters.get(n, 0) for s in records for n in names)
