"""Nanosecond wall-clock timer (counterpart of mpx/utils/timer.py)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start = time.perf_counter_ns()

    def elapsed(self) -> int:
        """Elapsed nanoseconds since construction."""
        return time.perf_counter_ns() - self.start

    @staticmethod
    def pretty(ns: int) -> str:
        if ns < 1_000:
            return f"{ns} ns"
        if ns < 1_000_000:
            return f"{ns / 1_000:.3f} us"
        if ns < 1_000_000_000:
            return f"{ns / 1_000_000:.3f} ms"
        return f"{ns / 1_000_000_000:.3f} s"
