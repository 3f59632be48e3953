"""FLOSS: online (streaming) semantic segmentation.

Counterpart of ``mpx/floss.py``.  FLOSS keeps the right profile of a
stream inside a bounded window and scores regime boundaries after every
append with the one-directional corrected arc curve
(:func:`mpx_torch.analysis.one_directional_cac`).  The expensive part of a
step, the new windows against the retained ones, is
:class:`mpx_torch.streaming.StreamingMatrixProfile`'s append on the
device (``mode='right'``); this module adds the O(window) host scoring.

Two properties make the streaming state exact: right arcs only improve as
the stream grows (a new window only adds candidates, which the append's
column merge applies), and they point from older to newer windows, so the
window's egress is a pure head trim.  ``Floss.cac()`` therefore equals the
one-directional CAC of the batch right profile of the retained series.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mpx_torch.analysis import extract_regimes, one_directional_cac
from mpx_torch.streaming import StreamingMatrixProfile


class Floss:
    """Streaming semantic segmentation over a sliding window.

    >>> fl = Floss(T0, m=64, window=4096, device="cpu")
    >>> fl.append(points)              # any chunk size, O(k * window)
    >>> fl.cac()                       # one-directional CAC, len = w
    >>> fl.regimes(k=1)                # absolute stream positions
    >>> fl.score                       # min CAC (lower = stronger boundary)

    ``window`` is the retained span in points (default: the initial
    series' length).  The state grows to ``slack * window`` before one
    trim back to ``window``."""

    def __init__(self, T, m: int, window: Optional[int] = None, dtype: str = "float32",
                 slack: float = 2.0, *, device: str = "cuda"):
        T = np.asarray(T, np.float64)
        if window is None:
            window = T.shape[0]
        if window < m + m // 4:
            raise ValueError(f"window {window} < m + m//4 = {m + m // 4}")
        if slack <= 1.0:
            raise ValueError("slack must be > 1 (trim hysteresis)")
        self.m = m
        self.window = int(window)
        self.slack = float(slack)
        init_drop = max(0, T.shape[0] - window)
        self._smp = StreamingMatrixProfile(T[init_drop:], m, dtype=dtype, mode="right",
                                           device=device)
        # absolute positions count from the start of the initial series
        self._smp.offset = init_drop

    @property
    def offset(self) -> int:
        """Absolute stream position of the window's first point."""
        return self._smp.offset

    @property
    def series(self) -> np.ndarray:
        """The retained points."""
        return self._smp.series

    def append(self, points) -> None:
        self._smp.append(np.atleast_1d(np.asarray(points, np.float64)))
        n = self._smp.series.shape[0]
        if n > self.slack * self.window:
            self._smp.trim_head(n - self.window)

    def profile(self):
        """The window's right matrix profile (MP, MPI); MPI is relative to
        the window (add ``offset`` for stream positions)."""
        return self._smp.profile()

    def cac(self) -> np.ndarray:
        """One-directional corrected arc curve over the window."""
        _, MPI = self._smp.profile()
        return one_directional_cac(MPI, self.m)

    @property
    def score(self) -> float:
        """min(CAC): 1.0 = no boundary evidence, toward 0 = boundary."""
        return float(self.cac().min())

    def regimes(self, k: int = 1) -> List[int]:
        """The k strongest regime boundaries, in absolute stream positions."""
        return [self.offset + r for r in extract_regimes(self.cac(), self.m, k=k)]
