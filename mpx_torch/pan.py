"""Pan matrix profile: the profile surface over a range of window sizes.

Counterpart of ``mpx/pan.py``.  The pan profile (SKIMP, Madrid et al.
2019) computes the profile for a whole range of window sizes and
normalizes them onto a comparable scale, so motif structure at any length
shows up in one (len(ms) x w) surface.  ``method='fused'`` sweeps every
length in one pass (:mod:`mpx_torch.pan_kernel`, float32);
``method='exact'`` runs one :func:`mpx_torch.driver.compute_matrix_profile`
a length, which reaches K1 or K3 through ``auto`` as the driver routes
them.  Both run on ``config.device``; the surface comes back on the host,
as mpx's.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx_torch.config import MatrixProfileConfig
from mpx_torch.dtypes import canonical_dtype


class PanProfile(NamedTuple):
    ms: np.ndarray    # (R,) int window sizes, ascending
    PMP: np.ndarray   # (R, w_max) float64 distances; +inf beyond row width
    PMPI: np.ndarray  # (R, w_max) int32 indices; -1 beyond row width

    @property
    def normalized(self) -> np.ndarray:
        """Distances scaled to [0, 1] per row (d / (2*sqrt(m)), the
        SKIMP normalization), so rows compare across m.  Unmatched
        windows (padding tails and degenerate zero-variance subsequences,
        whose stored distance is the huge aggregate-init sentinel) come
        out as NaN."""
        scale = 2.0 * np.sqrt(self.ms.astype(np.float64))
        out = self.PMP / scale[:, None]
        matched = np.isfinite(self.PMP) & (self.PMPI >= 0)
        return np.where(matched, out, np.nan)


def pan_m_range(lo: int, hi: int, count: int = 16) -> np.ndarray:
    """Log-spaced window sizes in [lo, hi], deduplicated, ascending; both
    endpoints are always included."""
    if lo < 4:
        raise ValueError("m must be >= 4 (exclusion zone is m/4)")
    if hi < lo:
        raise ValueError(f"empty range [{lo}, {hi}]")
    ms = np.round(np.geomspace(lo, hi, max(count, 1))).astype(np.int64)
    return np.unique(np.concatenate([ms, [lo, hi]]))


def compute_pan_profile(
    T,
    ms: Sequence[int],
    config: Optional[MatrixProfileConfig] = None,
    method: str = "auto",
    profile=None,
) -> PanProfile:
    """Matrix profile at every window size in ``ms``.

    ``config`` (optional) carries dtype, kernel, schedule and device; its
    ``m`` is ignored.  Without one the run takes the card.

    ``method``:

    * ``'fused'``: all window lengths in one sweep of the pair grid
      (:func:`mpx_torch.pan_kernel.run_pan_jobs`), float32-grade rows
      (within 2e-3 of the exact per-m profiles);
    * ``'exact'``: one run of the exact single-m pipeline a length,
      largest m first;
    * ``'auto'``: fused for float32 configs (and when no config is
      given), exact for float64.

    ``profile`` (:class:`mpx_torch.utils.profile.BenchmarkProfile`) takes
    the fused sweep's phases, or each exact run's.
    """
    from mpx_torch.driver import compute_matrix_profile

    T = np.asarray(T)
    if config is not None and config.input_quant is not None:
        # The fixed-point input tier: quantize once here, so the fused
        # sweep sees the cast input that the exact pipeline computes on.
        from mpx_torch.io.apfixed import quantize

        T = quantize(T, config.input_quant)
    ms_arr = np.unique(np.asarray(list(ms), dtype=np.int64))
    if ms_arr.size == 0:
        raise ValueError("ms is empty")
    if method not in ("auto", "fused", "exact"):
        raise ValueError(f"unknown pan method {method!r}")
    if method == "auto":
        method = ("exact" if config is not None
                  and canonical_dtype(config.dtype) == np.dtype(np.float64) else "fused")
    if config is None:
        dtype = "float32" if method == "fused" else "float64"
        config = MatrixProfileConfig(m=int(ms_arr[0]), dtype=dtype)
    n = T.shape[0]
    if n - int(ms_arr[-1]) + 1 < 2:
        raise ValueError(f"largest m={int(ms_arr[-1])} leaves no pairs for n={n}")
    w_max = n - int(ms_arr[0]) + 1
    R = ms_arr.size

    if method == "fused":
        from mpx_torch.pan_kernel import run_pan_jobs

        cfg = dataclasses.replace(config, m=int(ms_arr[0])).shrink_to(w_max)
        PMP, PMPI = run_pan_jobs(T, [int(m) for m in ms_arr], band=cfg.band,
                                 chunk=cfg.chunk, device=cfg.device, profile=profile)
        return PanProfile(ms=ms_arr, PMP=PMP.cpu().numpy(), PMPI=PMPI.cpu().numpy())

    PMP = np.full((R, w_max), np.inf, np.float64)
    PMPI = np.full((R, w_max), -1, np.int32)
    for r in range(R - 1, -1, -1):
        m = int(ms_arr[r])
        MP, MPI = compute_matrix_profile(T, config=dataclasses.replace(config, m=m),
                                         profile=profile)
        wm = n - m + 1
        PMP[r, :wm] = MP.cpu().numpy().astype(np.float64)
        PMPI[r, :wm] = MPI.cpu().numpy()
    return PanProfile(ms=ms_arr, PMP=PMP, PMPI=PMPI)


class PanMotif(NamedTuple):
    m: int            # window size the motif was found at
    a: int            # earlier occurrence start
    b: int            # later occurrence start
    distance: float   # raw z-normalized distance at that m
    score: float      # SKIMP-normalized distance (comparable across m)


def _suppress_span(score: np.ndarray, ms: np.ndarray, pos: int, span: int,
                   fill: float = np.inf):
    """Mask (to ``fill``) every (row, start) whose window overlaps
    [pos, pos+span): window [s, s+m_r) overlaps iff s in (pos - m_r,
    pos + span)."""
    w = score.shape[1]
    for r in range(score.shape[0]):
        lo = max(0, pos - int(ms[r]) + 1)
        score[r, lo : min(w, pos + span)] = fill


def pan_motifs(pan: PanProfile, k: int = 3) -> List[PanMotif]:
    """k best variable-length motifs from a pan surface: global minima of
    the cross-m normalized surface, each suppressing every window (at
    every length) that overlaps either occurrence, so successive motifs
    are disjoint spans, possibly at different window sizes."""
    norm = pan.normalized
    score = np.where(np.isnan(norm), np.inf, norm)
    out: List[PanMotif] = []
    claimed: List[tuple] = []
    w = score.shape[1]
    while len(out) < k:
        r, i = divmod(int(score.argmin()), w)
        if not np.isfinite(score[r, i]):
            break
        m_r = int(pan.ms[r])
        j = int(pan.PMPI[r, i])
        # The source cell is unsuppressed, but its partner may still lie
        # in a claimed span (suppression masks sources only): such a
        # candidate is part of a pattern already taken.
        if any(j < hi and j + m_r > lo for lo, hi in claimed):
            score[r, i] = np.inf
            continue
        a, b = (i, j) if i <= j else (j, i)
        out.append(PanMotif(m_r, a, b, float(pan.PMP[r, i]), float(norm[r, i])))
        _suppress_span(score, pan.ms, a, m_r)
        _suppress_span(score, pan.ms, b, m_r)
        claimed += [(a, a + m_r), (b, b + m_r)]
    return out


def pan_discords(pan: PanProfile, k: int = 3) -> List[PanMotif]:
    """k strongest variable-length discords: maxima of the normalized
    surface, with the same cross-length overlap suppression of the
    discord's own span.  Returned as PanMotif records with ``b = PMPI``
    (the nearest neighbor it is far from)."""
    norm = pan.normalized
    score = np.where(np.isnan(norm), -np.inf, norm)
    out: List[PanMotif] = []
    w = score.shape[1]
    while len(out) < k:
        r, i = divmod(int(score.argmax()), w)
        if not np.isfinite(score[r, i]):
            break
        m_r = int(pan.ms[r])
        out.append(PanMotif(m_r, i, int(pan.PMPI[r, i]), float(pan.PMP[r, i]),
                            float(norm[r, i])))
        _suppress_span(score, pan.ms, i, m_r, fill=-np.inf)
    return out
