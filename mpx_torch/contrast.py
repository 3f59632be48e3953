"""Contrast profile: patterns present in one series and absent in another.

Counterpart of ``mpx/contrast.py``.  Given a "positive" series ``T+`` and
a "negative" series ``T-``,

    CP(i) = clip(MP_AB(i) - MP_AA(i), 0) / sqrt(2 m)        (clipped to [0, 1])

where ``MP_AA`` is the self-join profile of ``T+`` and ``MP_AB`` the
AB-join profile of ``T+`` against ``T-``.  A high ``CP(i)`` marks a
window that repeats within ``T+`` while nothing like it exists in ``T-``.

Both joins are the port's tiers (:func:`mpx_torch.driver.compute_matrix_profile`
and :func:`mpx_torch.abjoin.compute_ab_join`) on ``config.device``, so the
contrast profile takes every option of theirs.  mpx's ``auto`` sends
float64 to its hybrid because the TPU has no float64; the port's ``auto``
takes the card's own float64 for both joins: K3 for the self-join from
``K3_MIN_M_F64`` (K1 below it) and K1 for the AB-join, as its driver and
AB-join route them.

Dividing by sqrt(2m) puts the positively correlated regime in [0, 1]:
``d = sqrt(2 m (1 - r))`` with Pearson ``r`` in [-1, 1], so ``d <= 2 sqrt(m)``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for
from mpx_torch.reference import exclusion_zone


class ContrastResult(NamedTuple):
    cp: np.ndarray      # (w+,) contrast profile in [0, 1]
    mp_aa: np.ndarray   # (w+,) T+ self-join profile
    mp_ab: np.ndarray   # (w+,) T+ -> T- AB-join profile
    mpi_aa: np.ndarray  # (w+,) self-join nearest-neighbor index (into T+)
    mpi_ab: np.ndarray  # (w+,) AB-join nearest-neighbor index (into T-)


class ContrastMotif(NamedTuple):
    index: int        # position in T+
    neighbor: int     # its nearest in-class neighbor (position in T+)
    score: float      # CP value in [0, 1]


def _contrast_from_profiles(mp_aa, mp_ab, mpi_aa, mpi_ab, m: int) -> np.ndarray:
    mp_aa = np.asarray(mp_aa, dtype=np.float64)
    mp_ab = np.asarray(mp_ab, dtype=np.float64)
    cp = np.clip((mp_ab - mp_aa) / np.sqrt(2.0 * m), 0.0, 1.0)
    # Untouched or flat entries carry the sqrt(2m(1+1e12)) sentinel and
    # index -1.  Without a T+ neighbor there is no motif to contrast (CP
    # = 0); without a T- neighbor the pattern has nothing comparable in
    # the minus class (CP = 1).
    valid_aa = (np.asarray(mpi_aa) >= 0) & np.isfinite(mp_aa)
    valid_ab = (np.asarray(mpi_ab) >= 0) & np.isfinite(mp_ab)
    cp = np.where(valid_ab, cp, 1.0)
    return np.where(valid_aa, cp, 0.0)


def contrast_profile(
    T_plus,
    T_minus,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    profile=None,
) -> ContrastResult:
    """Contrast profile of ``T_plus`` against ``T_minus`` at window ``m``.

    ``config`` routes both joins (dtype, kernel, band, chunk, device);
    ``profile`` (a BenchmarkProfile) takes both joins' phase times.
    Returns numpy arrays."""
    from mpx_torch.abjoin import compute_ab_join
    from mpx_torch.driver import compute_matrix_profile

    config = config_for(m, config)
    m = config.m
    mp_aa, mpi_aa = (x.cpu().numpy() for x in
                     compute_matrix_profile(T_plus, config=config, profile=profile))
    ab = compute_ab_join(T_plus, T_minus, config=config, profile=profile)
    mp_ab, mpi_ab = ab.mp_a.cpu().numpy(), ab.mpi_a.cpu().numpy()
    cp = _contrast_from_profiles(mp_aa, mp_ab, mpi_aa, mpi_ab, m)
    return ContrastResult(cp=cp, mp_aa=mp_aa, mp_ab=mp_ab, mpi_aa=mpi_aa, mpi_ab=mpi_ab)


def top_contrast_motifs(result: ContrastResult, m: int, k: int = 3) -> List[ContrastMotif]:
    """k highest-CP motifs, each suppressing an m/2 trivial-match zone
    around the peak and around its in-class neighbor."""
    cp = result.cp.copy()
    zone = max(exclusion_zone(m), m // 2)
    alive = cp > 0.0
    out: List[ContrastMotif] = []
    while len(out) < k and alive.any():
        i = int(np.where(alive, cp, -np.inf).argmax())
        if cp[i] <= 0.0:
            break
        j = int(result.mpi_aa[i])
        out.append(ContrastMotif(index=i, neighbor=j, score=float(cp[i])))
        lo = max(0, i - zone)
        alive[lo : i + zone + 1] = False
        if j >= 0:
            lo = max(0, j - zone)
            alive[lo : j + zone + 1] = False
    return out


def pan_contrast_profile(
    T_plus,
    T_minus,
    ms: Sequence[int],
    config: Optional[MatrixProfileConfig] = None,
) -> List[Tuple[int, np.ndarray]]:
    """Contrast profile at each window in ``ms``: ``[(m, cp_m)]``, sorted by
    m.  All share the [0, 1] scale, so the global peak
    (:func:`best_contrast`) is the best (m, i) pattern.  Each length runs
    with the full ``config`` but its ``m``."""
    from dataclasses import replace

    out: List[Tuple[int, np.ndarray]] = []
    for m in sorted(set(int(m) for m in ms)):
        cfg = MatrixProfileConfig(m=m) if config is None else replace(config, m=m)
        out.append((m, contrast_profile(T_plus, T_minus, config=cfg).cp))
    return out


def best_contrast(pan: List[Tuple[int, np.ndarray]]) -> Tuple[int, int, float]:
    """(m, index, score) of the global peak of a pan contrast profile."""
    best = (0, 0, -1.0)
    for m, cp in pan:
        if cp.size == 0:
            continue
        i = int(cp.argmax())
        if float(cp[i]) > best[2]:
            best = (m, i, float(cp[i]))
    return best


def brute_force_contrast_profile(T_plus, T_minus, m: int) -> np.ndarray:
    """O(n^2) float64 oracle, from the port's brute-force join oracles."""
    from mpx_torch.abjoin import brute_force_ab_join
    from mpx_torch.reference import brute_force_matrix_profile

    mp_aa, mpi_aa = brute_force_matrix_profile(np.asarray(T_plus, np.float64), m)
    mp_ab, mpi_ab, _, _ = brute_force_ab_join(np.asarray(T_plus, np.float64),
                                              np.asarray(T_minus, np.float64), m)
    return _contrast_from_profiles(mp_aa, mp_ab, mpi_aa, mpi_ab, m)
