"""DAMP-style anomaly detection (left-discord monitoring).

Counterpart of ``mpx/damp.py``.  DAMP (Lu et al., KDD 2022) scores each
arriving window by its left-profile value: the z-normalized distance to
the nearest EARLIER window.  A window far from everything before it is an
anomaly the moment it arrives, and its score never changes later (the
left profile is append-stable).

* :func:`compute_damp` — the batch scorer: one left/right profile through
  the driver (``auto``: on the card K3 for float64 from ``K3_MIN_M_F64``,
  K1 else, where mpx's ``auto`` sends float64 to its hybrid), anomalies
  ranked after ``split``.
* :class:`OnlineAnomalyDetector` — the streaming scorer: the streaming
  tier's append in ``mode='left'`` (:mod:`mpx_torch.streaming`: the new
  rows against earlier columns only, no column merge, so emitted scores
  are final); each append fetches only its own k scores.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for
from mpx_torch.driver import compute_matrix_profile
from mpx_torch.reference import exclusion_zone
from mpx_torch.streaming import StreamingMatrixProfile


class Anomaly(NamedTuple):
    index: int        # absolute window position in the stream
    distance: float   # left-profile distance when it arrived


class DampResult(NamedTuple):
    scores: np.ndarray       # (w,) left-profile distances
    discords: List[Anomaly]  # top anomalies, strongest first
    split: int               # scores before this window index are training


def compute_damp(
    T,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    split: int = 0,
    k: int = 3,
) -> DampResult:
    """Batch DAMP: the exact left profile of ``T`` (float64 numpy scores),
    anomalies ranked over windows >= ``split`` (the training prefix is
    never reported).  The top anomaly is DAMP's best-so-far discord,
    computed exactly."""
    config = config_for(m, config)
    m = config.m
    MPl, MPIl, _, _ = compute_matrix_profile(T, config=config, left_right=True)
    scores = MPl.cpu().numpy().astype(np.float64)
    idx = MPIl.cpu().numpy()
    w = scores.shape[0]
    if not 0 <= split < w:
        raise ValueError(f"split {split} outside [0, {w})")
    # windows with no earlier neighbor (the first ones, flat ones) are
    # unscorable, not anomalies
    scorable = (idx >= 0) & np.isfinite(scores)
    ranked = np.where(scorable, scores, -np.inf)
    ranked[:split] = -np.inf
    zone = max(exclusion_zone(m), m // 2)
    discords: List[Anomaly] = []
    for _ in range(max(k, 0)):
        i = int(ranked.argmax())
        if not np.isfinite(ranked[i]):
            break
        discords.append(Anomaly(index=i, distance=float(scores[i])))
        ranked[max(0, i - zone + 1) : i + zone] = -np.inf
    return DampResult(scores=scores, discords=discords, split=split)


class OnlineAnomalyDetector:
    """Streaming DAMP: score every arriving window on append.

    >>> det = OnlineAnomalyDetector(T_train, config=MatrixProfileConfig(m=64, device="cpu"))
    >>> alerts = det.append(points)   # windows beating the discord
    >>> det.discord                   # best-so-far anomaly
    >>> det.scores(lo, hi)            # any scored span, O(hi-lo)

    ``threshold``: the distance above which a window alerts; ``None``
    alerts whenever a window beats the best-so-far discord (DAMP's BSF
    rule).  Training windows (the initial series) never alert."""

    def __init__(self, T_train, m: Optional[int] = None,
                 config: Optional[MatrixProfileConfig] = None, *,
                 threshold: Optional[float] = None):
        config = config_for(m, config)
        self.m = config.m
        self.threshold = threshold
        self._smp = StreamingMatrixProfile(T_train, self.m, dtype=config.dtype, mode="left",
                                           device=config.device)
        self.split = self._smp._w  # first scorable window
        self._bsf: Optional[Anomaly] = None

    @property
    def series(self) -> np.ndarray:
        return self._smp.series

    def profile(self):
        """The whole left profile so far (MP_left, MPI_left): an O(n)
        fetch; per-append consumers use :meth:`scores`."""
        return self._smp.profile()

    @property
    def discord(self) -> Optional[Anomaly]:
        """Best-so-far anomaly among the scored (post-training) windows."""
        return self._bsf

    def scores(self, lo: int, hi: int) -> np.ndarray:
        """Left-profile distances of windows [lo, hi); O(hi-lo)."""
        return self._smp.row_values(lo, hi)

    def append(self, points) -> List[Anomaly]:
        """Ingest points; return the alerts among the new windows (final on
        emission).  Cost: one O(k * n) product on the device and an O(k)
        fetch."""
        old_w = self._smp._w
        self._smp.append(points)
        w = self._smp._w
        if w == old_w:
            return []
        vals = self._smp.row_values(old_w, w)
        # untouched slots (flat windows, masked out of every sweep) carry the
        # aggregate init: unscorable, not anomalies
        smax = np.sqrt(2.0 * self.m * (1.0 + 1e11))
        alerts: List[Anomaly] = []
        for j, d in enumerate(vals):
            if not np.isfinite(d) or d >= smax:
                continue
            a = Anomaly(index=old_w + j, distance=float(d))
            if self._bsf is None or d > self._bsf.distance:
                self._bsf = a
                if self.threshold is None:
                    alerts.append(a)
            if self.threshold is not None and d > self.threshold:
                alerts.append(a)
        return alerts
