"""Exact multi-length discords and motifs (the MERLIN use case).

Counterpart of ``mpx/merlin.py``.  Two stages:

1. **Survey**: one fused pan sweep (:mod:`mpx_torch.pan_kernel`) scores
   every window at every requested length in a single pass of the pair
   grid; float32-grade rows.
2. **Refine**: per length, every window whose survey value is within
   ``2 * eps`` of the row's extremum is re-scanned exactly, as float64
   tensors on the device (:func:`mpx_torch.hybrid._row_scan`); the exact
   extremum among them is the answer.  With the survey's absolute error
   bounded by ``eps``, the true extremum lies inside that candidate band.

Two defences keep "exact" honest: a band wider than ``_MAX_CANDIDATES``,
and an observed survey error of at least ``eps`` among the rescored
candidates, each send the length to a full exact float64 profile through
the hybrid tier (:func:`mpx_torch.hybrid.compute_matrix_profile_f64_hybrid`,
whose pass A is K1's float32 launch).  ``escalate=False`` truncates the
band instead and reports the length in ``truncated_lengths``.  ``eps`` is
mpx's; ``chip_smoke.py`` measures the port's own survey error against it.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig
from mpx_torch.utils.logging import Logger
from mpx_torch.utils.profile import phase

# Survey-error allowance (absolute, z-normalized distance units): the fused
# pan tier is held to 2e-3 of the exact per-m profiles; 5e-3 leaves a 2.5x
# safety factor, and the refine stage checks it at run time.
_DEFAULT_EPS = 5e-3

# Refine-stage cap: candidate rows per length.  A wider band (near-constant
# or heavily repeating input) escalates that length to a full exact
# profile, or is truncated to the strongest _MAX_CANDIDATES with
# escalate=False.
_MAX_CANDIDATES = 4096


class LengthDiscord(NamedTuple):
    m: int            # window length
    index: int        # discord start
    nn_index: int     # its (exact) nearest neighbor
    distance: float   # exact float64 z-normalized NN distance
    score: float      # length-normalized distance d / (2*sqrt(m))


class MerlinResult(NamedTuple):
    per_length: List[LengthDiscord]  # exact top-1 per length
    top: List[LengthDiscord]         # k best across lengths, overlap-suppressed
    # lengths whose candidate band overflowed (or whose survey error check
    # tripped) and were re-swept exactly instead:
    escalated_lengths: List[int] = []
    # lengths where escalate=False truncated the band: their per_length
    # entry is "best of the strongest _MAX_CANDIDATES", NOT exact
    truncated_lengths: List[int] = []

    @property
    def exact(self) -> bool:
        """True iff every per-length entry carries the exactness
        guarantee (no truncated lengths)."""
        return not self.truncated_lengths


def _exact_row_rescore(T64, m: int, rows: np.ndarray, device="cuda"):
    """Exact float64 (distance, nn_index) of the given rows, as numpy
    arrays: host float64 statistics, the row scan as float64 tensors on
    ``device``."""
    from mpx_torch.hybrid import _row_scan
    from mpx_torch.ops.precompute import precompute_statistics_numpy

    w = T64.shape[0] - m + 1
    s = precompute_statistics_numpy(T64, m)
    P, I = _row_scan(*(torch.as_tensor(np.asarray(x, np.float64), device=device)
                       for x in (T64, s["mu"], s["inv"])),
                     m, w, m // 4, torch.as_tensor(np.asarray(rows, np.int64), device=device))
    D = torch.sqrt(torch.clamp(2.0 * m * (1.0 - P), min=0.0))
    return D.cpu().numpy(), I.cpu().numpy()


def _lengths(lo, hi, ms, k: int) -> np.ndarray:
    if ms is None:
        if lo is None or hi is None:
            raise ValueError("pass lo/hi or an explicit ms list")
        if lo < 4:
            raise ValueError("m must be >= 4 (exclusion zone is m/4)")
        if hi < lo:
            raise ValueError(f"empty length range [{lo}, {hi}]")
        ms = range(lo, hi + 1)
    ms_arr = np.unique(np.asarray(list(ms), dtype=np.int64))
    if ms_arr.size == 0:
        raise ValueError("ms is empty")
    if k < 1:
        raise ValueError("k must be >= 1")
    return ms_arr


def _multi_length(T, lo, hi, ms, k, eps, escalate, config, mode: str,
                  profile=None) -> MerlinResult:
    from mpx_torch.pan import compute_pan_profile

    T = np.asarray(T)
    ms_arr = _lengths(lo, hi, ms, k)
    pan = compute_pan_profile(T, [int(m) for m in ms_arr], config=config, method="fused",
                              profile=profile)
    T64 = np.asarray(T, np.float64)
    dev = torch.device("cuda" if config is None else config.device)
    with phase(profile, "4. Refine [merlin f64]", device=dev):
        per_length, escalated, truncated = _per_length_extreme(
            pan, T64, eps, mode=mode, escalate=escalate, config=config, profile=profile)
    top = _rank_suppress(per_length, k, best_first=mode == "discord")
    return MerlinResult(per_length=per_length, top=top, escalated_lengths=escalated,
                        truncated_lengths=truncated)


def multi_length_discords(
    T,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
    *,
    ms: Optional[Sequence[int]] = None,
    k: int = 3,
    eps: float = _DEFAULT_EPS,
    escalate: bool = True,
    config: Optional[MatrixProfileConfig] = None,
    profile=None,
) -> MerlinResult:
    """Exact top-1 discord at every length in [lo, hi] (or the explicit
    ``ms`` list), plus the ``k`` strongest across lengths.

    The cross-length ranking uses the SKIMP normalization
    ``d / (2*sqrt(m))`` and suppresses overlapping spans.  ``escalate``
    (default True) keeps exactness unconditional: a length whose
    candidate band overflows _MAX_CANDIDATES, or whose observed survey
    error reaches ``eps``, is re-swept as a full exact float64 profile
    (``result.escalated_lengths``); ``escalate=False`` truncates instead
    (``result.truncated_lengths``, ``result.exact`` False).  The run takes
    ``config.device`` (the card without a config).  ``profile``
    (:class:`mpx_torch.utils.profile.BenchmarkProfile`) takes the survey's
    phases and the refine stage's time, and in ``profile.counts`` each
    length's candidates (``candidates_m<m>``) and observed survey error
    (``survey_err_m<m>``)."""
    return _multi_length(T, lo, hi, ms, k, eps, escalate, config, "discord", profile)


def multi_length_motifs(
    T,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
    *,
    ms: Optional[Sequence[int]] = None,
    k: int = 3,
    eps: float = _DEFAULT_EPS,
    escalate: bool = True,
    config: Optional[MatrixProfileConfig] = None,
    profile=None,
) -> MerlinResult:
    """Exact top-1 motif pair at every length in [lo, hi] (the VALMOD
    question, by the same survey and rescore as
    :func:`multi_length_discords` with the extremum flipped).  The
    cross-length ``top`` ranks by ``d / (2*sqrt(m))`` ascending and
    suppresses both spans of each chosen pair.  ``profile`` as for
    :func:`multi_length_discords`."""
    return _multi_length(T, lo, hi, ms, k, eps, escalate, config, "motif", profile)


def _exact_extreme_full(T64, m: int, mode: str, config) -> Optional[LengthDiscord]:
    """Escalation: the exact extremum at one length from a full exact
    float64 profile through the hybrid tier."""
    from mpx_torch.hybrid import compute_matrix_profile_f64_hybrid

    if config is None:
        cfg = MatrixProfileConfig(m=m, dtype="float64")
    else:
        cfg = dataclasses.replace(config, m=m, dtype="float64", kernel="auto")
    MP, MPI = (x.cpu().numpy() for x in compute_matrix_profile_f64_hybrid(T64, cfg))
    matched = np.isfinite(MP) & (MPI >= 0)
    if not matched.any():
        return None
    sign = 1.0 if mode == "discord" else -1.0
    i = int(np.argmax(np.where(matched, sign * MP, -np.inf)))
    return LengthDiscord(m=m, index=i, nn_index=int(MPI[i]), distance=float(MP[i]),
                         score=float(MP[i] / (2.0 * np.sqrt(m))))


def _per_length_extreme(pan, T64, eps: float, mode: str, escalate: bool = True,
                        config=None, profile=None):
    """Exact per-length extremum of the profile (max for discords, min for
    motifs) from the candidate band and the float64 rescore; see the
    module docstring for the two escalations.  Returns (entries,
    escalated_lengths, truncated_lengths)."""
    n = T64.shape[0]
    sign = 1.0 if mode == "discord" else -1.0
    dev = torch.device("cuda" if config is None else config.device)
    out: List[LengthDiscord] = []
    escalated: List[int] = []
    truncated: List[int] = []
    for r, m in enumerate(pan.ms):
        m = int(m)
        wm = n - m + 1
        row = pan.PMP[r, :wm]
        matched = np.isfinite(row) & (pan.PMPI[r, :wm] >= 0)
        if not matched.any():
            continue
        approx = np.where(matched, sign * row, -np.inf)
        cand = np.nonzero(approx >= float(approx.max()) - 2.0 * eps)[0]
        if profile is not None:
            profile.counts[f"candidates_m{m}"] = int(cand.shape[0])
        if cand.shape[0] > _MAX_CANDIDATES:
            if escalate:
                Logger.info(f"merlin m={m}: candidate band {cand.shape[0]} > "
                            f"{_MAX_CANDIDATES}; escalating to a full exact profile "
                            f"at this length")
                entry = _exact_extreme_full(T64, m, mode, config)
                if entry is not None:
                    out.append(entry)
                    escalated.append(m)
                continue
            Logger.warning(f"merlin m={m}: candidate band {cand.shape[0]} > "
                           f"{_MAX_CANDIDATES}; rescoring only the strongest "
                           f"{_MAX_CANDIDATES} (near-tied {mode}s) - NOT exact "
                           f"(escalate=False)")
            cand = cand[np.argsort(approx[cand])[::-1][:_MAX_CANDIDATES]]
            truncated.append(m)
        D, I = _exact_row_rescore(T64, m, cand, dev)
        # A candidate can be degenerate only in exact float64 (its float32
        # survey variance rounded away from zero): no valid neighbor there
        # means no extremum, not an astronomical one.
        Ds = np.where(I >= 0, sign * D, -np.inf)
        if not np.isfinite(Ds).any():
            continue
        # The run-time check of the eps allowance over the rescored band.
        chk = (I >= 0) & np.isfinite(row[cand])
        if chk.any():
            observed = float(np.abs(row[cand][chk] - D[chk]).max())
            if profile is not None:
                profile.counts[f"survey_err_m{m}"] = observed
            if observed >= eps:
                if escalate:
                    Logger.warning(f"merlin m={m}: observed survey error {observed:.2e} "
                                   f">= eps {eps:.2e}; escalating to a full exact "
                                   f"profile at this length")
                    entry = _exact_extreme_full(T64, m, mode, config)
                    if entry is not None:
                        out.append(entry)
                        escalated.append(m)
                    continue
                Logger.warning(f"merlin m={m}: observed survey error {observed:.2e} "
                               f">= eps {eps:.2e} with escalate=False - NOT exact")
                if m not in truncated:
                    truncated.append(m)
        best = int(np.argmax(Ds))
        out.append(LengthDiscord(m=m, index=int(cand[best]), nn_index=int(I[best]),
                                 distance=float(D[best]),
                                 score=float(D[best] / (2.0 * np.sqrt(m)))))
    return out, escalated, truncated


def _rank_suppress(per_length: List[LengthDiscord], k: int,
                   best_first: bool) -> List[LengthDiscord]:
    """Cross-length ranking (normalized score) with span suppression;
    motifs (best_first=False, ascending score) suppress both of the pair's
    spans."""
    order = sorted(per_length, key=lambda d: d.score, reverse=best_first)
    top: List[LengthDiscord] = []
    taken: List[tuple] = []
    for d in order:
        spans = [(d.index, d.index + d.m)]
        if not best_first and d.nn_index >= 0:
            spans.append((d.nn_index, d.nn_index + d.m))
        if any(s0 < t1 and t0 < s1 for s0, s1 in spans for t0, t1 in taken):
            continue
        top.append(d)
        taken.extend(spans)
        if len(top) >= k:
            break
    return top


def _brute_force(T, ms: Sequence[int], sign: float) -> List[LengthDiscord]:
    from mpx_torch.reference import compute_matrix_profile_reference

    T64 = np.asarray(T, np.float64)
    out: List[LengthDiscord] = []
    for m in np.unique(np.asarray(list(ms), dtype=np.int64)):
        m = int(m)
        MP, MPI = compute_matrix_profile_reference(T64, m)
        matched = np.isfinite(MP) & (MPI >= 0)
        if not matched.any():
            continue
        i = int(np.argmax(np.where(matched, sign * MP, -np.inf)))
        out.append(LengthDiscord(m=m, index=i, nn_index=int(MPI[i]), distance=float(MP[i]),
                                 score=float(MP[i] / (2.0 * np.sqrt(m)))))
    return out


def brute_force_multi_length_discords(T, ms: Sequence[int]) -> List[LengthDiscord]:
    """O(sum_m w_m^2 m) oracle: the exact discord per length from the
    numpy golden profile (test scale only)."""
    return _brute_force(T, ms, 1.0)


def brute_force_multi_length_motifs(T, ms: Sequence[int]) -> List[LengthDiscord]:
    """O(sum_m w_m^2 m) oracle: the exact motif pair per length."""
    return _brute_force(T, ms, -1.0)
