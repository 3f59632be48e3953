"""STUMPY-compatible API on the port, counterpart of
``mpx/compat/stumpy.py``.

STUMPY is the most widely used open-source matrix-profile library; a
user of the reference (or of SCAMP) most likely also holds STUMPY call
sites.  This module mirrors the STUMPY function surface over mpx_torch
tiers:

================  ===========================================
stumpy            mpx_torch tier
================  ===========================================
``stump``         driver left/right profiles (+ AB-join, top-k)
``stumpi``        :class:`mpx_torch.streaming.StreamingMatrixProfile` (x2)
``aamp``          :func:`mpx_torch.compute_aamp_profile`
``aampdist``      :func:`mpx_torch.aamp.aamp_mpdist` (raw AB-join MPdist)
``mass``          :func:`mpx_torch.analysis.mass`
``match``         :func:`mpx_torch.analysis.match`
``motifs``        argmin-of-profile + :func:`mpx_torch.analysis.match`
``fluss``         corrected arc curve + regime extraction
``floss``         :class:`mpx_torch.Floss` (sliding-window streaming)
``mstump``        :func:`mpx_torch.compute_multidim_profile`
``subspace``      :func:`mpx_torch.multidim_subspace`
``atsc``/``allc`` :mod:`mpx_torch.chains`
``snippets``      :func:`mpx_torch.snippets`
``ostinato``      :func:`mpx_torch.ostinato`
``mpdist``        :func:`mpx_torch.analysis.mpdist`
``scrump``        :func:`mpx_torch.anytime_matrix_profile` (anytime)
``stimp``         :func:`mpx_torch.compute_pan_profile` (pan / SKIMP)
================  ===========================================

``stumped``, ``gpu_stump`` and ``mstumped`` are aliases, as in mpx.  Every
function (and class) that computes takes ``device=`` ("cuda" by default;
"cpu" off the card); ``mass``, ``match``, ``motifs``, ``fluss``,
``subspace``, ``atsc``, ``allc`` and ``mmotifs`` run on the host.

Documented divergences (semantics, not bugs; mpx's):

* exclusion zone: ``m // 4`` (the reference's,
  MatrixProfileReference.hpp:72-79); STUMPY uses ``ceil(m / 4)`` —
  identical whenever 4 divides m, one window apart otherwise.
* degenerate (zero-variance) windows never match (distances to them are
  masked); STUMPY applies constant-subsequence special cases.
* ``stump`` returns a plain object ndarray of the same (w, 4) /
  (w, 2k+2) layout; indices are -1 where STUMPY also uses -1.
* ``snippets`` returns the (snippet values, indices, fractions) triple
  — the per-snippet profiles/areas/regime columns are not retained.
* ``stimp`` clamps ``min_m`` from STUMPY's default 3 to 4 (the exclusion
  zone is m // 4); read ``M_`` for the actual lengths.
* ``p`` (Minkowski) other than 2.0 and ``T_subseq_isconstant`` /
  ``normalize``-with-``p`` combinations are not provided.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from mpx_torch.analysis import _host
from mpx_torch.config import MatrixProfileConfig

__all__ = [
    "stump", "stumped", "gpu_stump", "stumpi", "aamp", "aampdist",
    "mass", "match", "motifs",
    "fluss", "floss", "mstump", "mstumped", "mmotifs", "subspace",
    "atsc", "allc",
    "snippets", "ostinato", "mpdist", "scrump", "stimp",
]


def _check_p(p: float):
    if p != 2.0:
        raise NotImplementedError("only p=2.0 (Euclidean) is provided")


def stump(T_A, m: int, T_B=None, ignore_trivial: bool = True,
          normalize: bool = True, p: float = 2.0, k: int = 1, *,
          device: str = "cuda"):
    """stumpy.stump: object array of shape (w, 4) —
    [profile, index, left index, right index] — or (w, 2k+2) for k > 1
    ([P_1..P_k, I_1..I_k, left, right]).

    ``T_B`` given: AB-join (each T_A subsequence's nearest neighbor in
    T_B; left/right columns are -1, like STUMPY).  ``normalize=False``
    routes to the raw-Euclidean (aamp) tier."""
    _check_p(p)
    T_A = np.asarray(T_A, np.float64)
    cfg = MatrixProfileConfig(m=m, device=device)
    if T_B is not None:
        if not normalize:
            raise NotImplementedError("raw-Euclidean AB-joins: use "
                                      "mpx_torch.compute_aamp_ab_join")
        if k != 1:
            raise NotImplementedError("k > 1 AB-joins have no mpx_torch tier")
        from mpx_torch.abjoin import compute_ab_join

        res = compute_ab_join(T_A, np.asarray(T_B, np.float64), m, config=cfg)
        P = _host(res.mp_a).astype(np.float64)
        I = _host(res.mpi_a).astype(np.int64)
        neg = np.full(P.shape[0], -1, np.int64)
        return np.stack([P, I, neg, neg], axis=1).astype(object)

    if not ignore_trivial:
        raise ValueError("self-joins require ignore_trivial=True "
                         "(a window's best match would be itself)")
    if not normalize:
        out = aamp(T_A, m, device=device)
        if k != 1:
            raise NotImplementedError("k > 1 raw-Euclidean: no mpx_torch tier")
        return out

    from mpx_torch.driver import compute_matrix_profile

    PL, IL, PR, IR = (_host(x) for x in compute_matrix_profile(T_A, config=cfg,
                                                                 left_right=True))
    PL, IL = PL.astype(np.float64), IL.astype(np.int64)
    PR, IR = PR.astype(np.float64), IR.astype(np.int64)
    IL = np.where(IL >= 0, IL, -1)
    IR = np.where(IR >= 0, IR, -1)
    # merged profile: elementwise better of left/right; ties keep the
    # LEFT (smaller-index) neighbor — the reference's equidistant rule
    left_wins = (PL <= PR) & (IL >= 0) | (IR < 0)
    P = np.where(left_wins, PL, PR)
    I = np.where(left_wins, IL, IR)
    P = np.where((IL < 0) & (IR < 0), np.inf, P)
    if k == 1:
        return np.stack([P, I, IL, IR], axis=1).astype(object)

    from mpx_torch.topk import compute_topk_profile

    D, J = compute_topk_profile(T_A, m, k=k, config=cfg)
    D = _host(D).astype(np.float64)
    J = _host(J).astype(np.int64)
    cols = [D[:, i] for i in range(k)] + [J[:, i] for i in range(k)]
    return np.stack(cols + [IL, IR], axis=1).astype(object)


def stumped(client, T_A, m: int, T_B=None, ignore_trivial: bool = True,
            normalize: bool = True, p: float = 2.0, k: int = 1, *,
            device: str = "cuda"):
    """stumpy.stumped (the dask-distributed stump): same result as
    :func:`stump`.  ``client`` is accepted and ignored — the port spreads
    over its own mesh (:mod:`mpx_torch.parallel`), not a dask cluster."""
    del client
    return stump(T_A, m, T_B=T_B, ignore_trivial=ignore_trivial,
                 normalize=normalize, p=p, k=k, device=device)


def gpu_stump(T_A, m: int, T_B=None, ignore_trivial: bool = True,
              device_id: int = 0, normalize: bool = True, p: float = 2.0,
              k: int = 1, *, device: str = "cuda"):
    """stumpy.gpu_stump: same result as :func:`stump` on ``device``;
    ``device_id`` is accepted and ignored (name the card in ``device``,
    e.g. "cuda:1")."""
    del device_id
    return stump(T_A, m, T_B=T_B, ignore_trivial=ignore_trivial,
                 normalize=normalize, p=p, k=k, device=device)


def mstumped(client, T, m: int, discords: bool = False, *, device: str = "cuda"):
    """stumpy.mstumped: same result as :func:`mstump`; ``client`` is
    accepted and ignored (see :func:`stumped`)."""
    del client
    return mstump(T, m, discords=discords, device=device)


def aamp(T, m: int, ignore_trivial: bool = True, p: float = 2.0, *,
         device: str = "cuda"):
    """stumpy.aamp: raw (non-normalized) Euclidean profile, (w, 4) object
    array; the aamp tier has no left/right split, so those columns are
    -1."""
    _check_p(p)
    if not ignore_trivial:
        raise ValueError("self-joins require ignore_trivial=True")
    from mpx_torch.aamp import compute_aamp_profile

    D, I = compute_aamp_profile(np.asarray(T, np.float64), m,
                                config=MatrixProfileConfig(m=m, device=device))
    D = _host(D).astype(np.float64)
    I = _host(I).astype(np.int64)
    neg = np.full(D.shape[0], -1, np.int64)
    return np.stack([D, I, neg, neg], axis=1).astype(object)


class stumpi:
    """stumpy.stumpi: incremental (streaming) matrix profile.

    Backed by TWO :class:`mpx_torch.streaming.StreamingMatrixProfile`
    instances (modes ``full`` and ``left``) so ``P_``/``I_`` and
    ``left_P_``/``left_I_`` all update in O(k*n) device work per append.

    Documented divergences (beyond the module-level ones):

    * ``egress=True`` (the STUMPY default) slides the REPORTED VIEW
      over the last ``len(T) - m + 1`` windows but keeps comparing new
      subsequences against the FULL retained history, where STUMPY
      compares only within the sliding window.  Distances are therefore
      exact nearest-over-history and can be SMALLER than STUMPY's when
      a window's nearest neighbor has already egressed.  Indices are
      absolute stream positions (as in STUMPY's egress mode).
    * compute is float32 on the device (stored float64): distances match
      a batch ``stump`` of the final series to ~2e-3 (the batch float32
      tier's tolerance).
    * ``mp`` (a precomputed seed profile) is accepted and ignored — the
      stream recomputes its bootstrap, which yields the same result.
    * unmatched windows report ``inf`` / index -1 like STUMPY.
    """

    def __init__(self, T, m: int, egress: bool = True,
                 normalize: bool = True, p: float = 2.0, k: int = 1,
                 mp=None, *, device: str = "cuda"):
        _check_p(p)
        if not normalize:
            raise NotImplementedError(
                "normalize=False (aampi): mpx_torch has no streaming "
                "raw-distance tier; recompute with "
                "mpx_torch.compute_aamp_profile per step"
            )
        if k != 1:
            raise NotImplementedError("k > 1 streaming has no mpx_torch tier")
        del mp
        from mpx_torch.streaming import StreamingMatrixProfile

        T = np.asarray(T, np.float64)
        self._m = int(m)
        self._egress = bool(egress)
        self._w0 = T.shape[0] - self._m + 1
        self._full = StreamingMatrixProfile(T, m=self._m, mode="full", device=device)
        self._left = StreamingMatrixProfile(T, m=self._m, mode="left", device=device)

    def update(self, t):
        """Append one value (or an array of values — an extension;
        STUMPY's update is strictly scalar)."""
        pts = np.atleast_1d(np.asarray(t, np.float64))
        self._full.append(pts)
        self._left.append(pts)

    def _view(self, stream):
        MP, MPI = stream.profile()
        MP = np.where(MPI >= 0, MP, np.inf)
        MPI = MPI.astype(np.int64)
        if self._egress:
            return MP[-self._w0:], MPI[-self._w0:]
        return MP, MPI

    @property
    def T_(self) -> np.ndarray:
        T = self._full.series
        if self._egress:
            return T[-(self._w0 + self._m - 1):]
        return T

    @property
    def P_(self) -> np.ndarray:
        return self._view(self._full)[0]

    @property
    def I_(self) -> np.ndarray:
        return self._view(self._full)[1]

    @property
    def left_P_(self) -> np.ndarray:
        return self._view(self._left)[0]

    @property
    def left_I_(self) -> np.ndarray:
        return self._view(self._left)[1]


def aampdist(T_A, T_B, m: int, percentage: float = 0.05,
             p: float = 2.0, *, device: str = "cuda") -> float:
    """stumpy.aampdist: MPdist over raw (non-normalized) Euclidean
    ABBA-join profiles — :func:`mpx_torch.aamp.aamp_mpdist`."""
    _check_p(p)
    from mpx_torch.aamp import aamp_mpdist

    return aamp_mpdist(np.asarray(T_A, np.float64), np.asarray(T_B, np.float64), m,
                       threshold=percentage, config=MatrixProfileConfig(m=m, device=device))


def mass(Q, T, normalize: bool = True) -> np.ndarray:
    """stumpy.mass: distance profile of ``Q`` against windows of ``T``
    (host float64)."""
    from mpx_torch.analysis import mass as _mass

    return _mass(np.asarray(Q, np.float64), np.asarray(T, np.float64),
                 normalize=normalize)


def match(Q, T, max_distance=None, max_matches: Optional[int] = None):
    """stumpy.match: (count, 2) array of [distance, index], nearest
    first, non-overlapping."""
    from mpx_torch.analysis import match as _match

    ms = _match(np.asarray(Q, np.float64), np.asarray(T, np.float64),
                max_distance=max_distance, max_matches=max_matches)
    if not ms:
        return np.empty((0, 2), object)
    return np.array([[mm.distance, mm.index] for mm in ms], object)


def motifs(T, P, min_neighbors: int = 1, max_distance=None,
           max_matches: int = 10, max_motifs: int = 1):
    """stumpy.motifs: (motif_distances, motif_indices), each
    (max_motifs, max_matches), padded with nan / -1.

    ``P`` is the 1-D profile column of :func:`stump` output.  Each
    motif is the current profile minimum; its occurrence list comes
    from a MASS match of that subsequence (min_neighbors gates
    acceptance), and accepted spans are suppressed before the next."""
    from mpx_torch.analysis import match as _match
    from mpx_torch.reference import exclusion_zone

    T = np.asarray(T, np.float64)
    P = np.asarray(P, np.float64).copy()
    w = P.shape[0]
    m = T.shape[0] - w + 1
    zone = max(exclusion_zone(m), 1)
    dists = np.full((max_motifs, max_matches), np.nan)
    idxs = np.full((max_motifs, max_matches), -1, np.int64)
    found = 0
    while found < max_motifs and np.isfinite(P).any():
        i = int(np.nanargmin(np.where(np.isfinite(P), P, np.nan)))
        ms = _match(T[i : i + m], T, max_distance=max_distance, max_matches=max_matches)
        if len(ms) - 1 < min_neighbors:  # the first match is (near) itself
            P[max(0, i - zone) : i + zone + 1] = np.inf
            continue
        for j, mm in enumerate(ms[:max_matches]):
            dists[found, j] = mm.distance
            idxs[found, j] = mm.index
            P[max(0, mm.index - zone) : mm.index + zone + 1] = np.inf
        found += 1
    return dists[:found], idxs[:found]


def fluss(I, L: int, n_regimes: int, excl_factor: int = 5):
    """stumpy.fluss: (corrected arc curve, regime change locations).
    ``n_regimes`` regimes have ``n_regimes - 1`` change points."""
    del excl_factor  # the extractor uses the FLUSS 5*m zone already
    from mpx_torch.analysis import corrected_arc_curve, extract_regimes

    cac = corrected_arc_curve(_host(I), L)
    locs = extract_regimes(cac, L, k=max(n_regimes - 1, 1))
    return cac, np.asarray(locs, np.int64)


def floss(mp, T, m: int, L: int, excl_factor: int = 5, *, device: str = "cuda"):
    """stumpy.floss: a streaming segmentation object.  The port's
    :class:`~mpx_torch.floss.Floss` IS that object (sliding window, exact
    right profile); ``mp`` and ``excl_factor`` are accepted for
    signature parity and ignored (the stream recomputes its own state).
    ``L`` maps to the subsequence length m (STUMPY uses L == m in its own
    examples); use ``.append`` / ``.cac()`` / ``.regimes()``."""
    del mp, excl_factor
    if L != m:
        raise NotImplementedError("mpx_torch floss assumes L == m")
    from mpx_torch.floss import Floss as _Floss

    return _Floss(np.asarray(T, np.float64), m, device=device)


def mstump(T, m: int, discords: bool = False, *, device: str = "cuda"):
    """stumpy.mstump: (P, I) each of shape (d, w); row k-1 is the
    k-dimensional profile."""
    from mpx_torch.mstamp import compute_multidim_profile

    res = compute_multidim_profile(np.asarray(T, np.float64), discords=discords,
                                   config=MatrixProfileConfig(m=m, device=device))
    return np.asarray(res.PMP, np.float64), np.asarray(res.PMPI, np.int64)


def mmotifs(T, P, I, min_neighbors: int = 1, max_distance=None,
            cutoffs=None, max_matches: int = 10, max_motifs: int = 1,
            k=None, include=None):
    """stumpy.mmotifs: multi-dimensional motif discovery over an
    mstump result — (motif_distances, motif_indices, motif_subspaces,
    motif_mdls).

    Per motif round: the meaningful dimensionality is chosen by MDL
    (``k=None``, :func:`mpx_torch.multidim_mdl`) or fixed (``k`` = NUMBER
    of dimensions, 1-based — unlike :func:`subspace`, whose ``k`` is
    STUMPY's 0-based profile row); occurrences are found by the mean MASS
    distance profile over the chosen subspace dimensions (min_neighbors
    gates acceptance, matched spans are suppressed before the next
    round).  ``cutoffs`` (scalar or per-round) stops rounds whose profile
    minimum exceeds it."""
    from mpx_torch.analysis import mass as _mass
    from mpx_torch.mstamp import (
        MultiProfile,
        multidim_mdl,
        multidim_motif,
        multidim_subspace,
    )
    from mpx_torch.reference import exclusion_zone

    T = np.asarray(T, np.float64)
    if T.ndim == 1:
        T = T[None, :]
    d, n = T.shape
    P = np.asarray(P, np.float64).copy()
    I = np.asarray(I, np.int64)
    w = P.shape[1]
    m = n - w + 1
    zone = max(exclusion_zone(m), 1)
    if cutoffs is None:
        cutoffs = np.full(max_motifs, np.inf)
    else:
        cutoffs = np.broadcast_to(np.asarray(cutoffs, np.float64), (max_motifs,))

    motif_distances, motif_indices = [], []
    motif_subspaces, motif_mdls = [], []
    for round_ in range(max_motifs):
        prof = MultiProfile(PMP=P, PMPI=I)
        if k is None:
            try:
                res = multidim_mdl(T, m, profile=prof, include=include)
            except ValueError:
                break
            kk = res.best_k
            mdl_bits = res.bitsaves
        else:
            kk = int(k)
            mdl_bits = None
        try:
            i, j, dist = multidim_motif(prof, kk)
        except ValueError:
            break
        if dist > cutoffs[round_]:
            break
        dims = multidim_subspace(T, m, i, j, kk, include=include)
        D = np.mean([_mass(T[t, i : i + m], T[t]) for t in dims], axis=0)
        finite = D[np.isfinite(D)]
        md = max_distance
        if md is None and finite.size:
            md = float(max(finite.min(), finite.mean() - 2.0 * finite.std()))
        dists = np.full(max_matches, np.nan)
        idxs = np.full(max_matches, -1, np.int64)
        alive = np.isfinite(D)
        found = 0
        while alive.any() and found < max_matches:
            q = int(np.where(alive, D, np.inf).argmin())
            if not alive[q] or D[q] > md:
                break
            dists[found] = D[q]
            idxs[found] = q
            alive[max(0, q - zone) : q + zone + 1] = False
            # suppress the occurrence in every profile row so the next
            # round finds a different motif
            P[:, max(0, q - zone) : min(w, q + zone + 1)] = np.inf
            found += 1
        if found - 1 < min_neighbors:  # the first match is (near) itself
            # suppress the failed seed pair before moving on, or every
            # remaining round re-derives this same candidate
            for q in (i, j):
                P[:, max(0, q - zone) : min(w, q + zone + 1)] = np.inf
            continue
        motif_distances.append(dists)
        motif_indices.append(idxs)
        motif_subspaces.append(dims)
        motif_mdls.append(mdl_bits)
    return (np.asarray(motif_distances), np.asarray(motif_indices),
            motif_subspaces, motif_mdls)


def subspace(T, m: int, subseq_idx: int, nn_idx: int, k: int,
             discords: bool = False) -> np.ndarray:
    """stumpy.subspace: the k+1 dimensions forming the (subseq, nn)
    pair at profile row k (STUMPY's k is the 0-based row)."""
    from mpx_torch.mstamp import multidim_subspace

    return np.asarray(
        multidim_subspace(np.asarray(T, np.float64), m, subseq_idx, nn_idx, k + 1,
                          discords=discords),
        np.int64)


def atsc(IL, IR, j: int) -> np.ndarray:
    """stumpy.atsc: anchored time-series chain through ``j``."""
    from mpx_torch.chains import anchored_chain

    return np.asarray(anchored_chain(_host(IL), _host(IR), j), np.int64)


def allc(IL, IR):
    """stumpy.allc: (all chains as a list of index arrays, the longest
    unanchored chain)."""
    from mpx_torch.analysis import unanchored_chain
    from mpx_torch.chains import all_chains

    IL, IR = _host(IL), _host(IR)
    S = [np.asarray(c, np.int64) for c in all_chains(IL, IR)]
    C = np.asarray(unanchored_chain(IL, IR), np.int64)
    return S, C


def snippets(T, m: int, k: int, percentage: float = 1.0, *, device: str = "cuda"):
    """stumpy.snippets, reduced: (snippet values (k, m), start indices
    (k,), covered fractions (k,)).  The per-snippet profile/area/regime
    columns are not retained.  ``percentage`` scales the comparison
    window like STUMPY's ``s = round(m * percentage)`` (the port's own
    default of m // 2 is NOT applied here); the default 1.0 clamps to
    ``s = m - 1`` — the segment-vs-series AB-join needs at least two
    windows per segment."""
    from mpx_torch.snippets import snippets as _snippets

    T = np.asarray(T, np.float64)
    mc = min(max(4, int(round(m * percentage))), m - 1)
    out = _snippets(T, m, k, mc, config=MatrixProfileConfig(m=mc, device=device))
    vals = np.stack([T[s.start : s.start + m] for s in out])
    return (vals, np.array([s.start for s in out], np.int64),
            np.array([s.fraction for s in out]))


def ostinato(Ts: List, m: int, *, device: str = "cuda"):
    """stumpy.ostinato: (radius, series index, subsequence index) of the
    consensus motif."""
    from mpx_torch.ostinato import ostinato as _ostinato

    res = _ostinato(Ts, config=MatrixProfileConfig(m=m, device=device))
    return float(res.radius), int(res.series), int(res.index)


def mpdist(T_A, T_B, m: int, percentage: float = 0.05, *, device: str = "cuda") -> float:
    """stumpy.mpdist: the MPdist distance between two series."""
    from mpx_torch.analysis import mpdist as _mpdist

    return float(_mpdist(np.asarray(T_A, np.float64), np.asarray(T_B, np.float64), m,
                         threshold=percentage,
                         config=MatrixProfileConfig(m=m, device=device)))


class scrump:
    """stumpy.scrump: anytime matrix profile — call :meth:`update` to
    refine; read ``P_`` / ``I_``.  Backed by the anytime tier (job
    subsets with exact max-merges; values are monotone upper bounds)."""

    def __init__(self, T, m: int, percentage: float = 0.01,
                 pre_scrimp: bool = False, *, device: str = "cuda"):
        if pre_scrimp:
            raise NotImplementedError("pre_scrimp has no mpx_torch analog")
        from mpx_torch.anytime import anytime_matrix_profile

        batches = max(1, min(256, math.ceil(1.0 / percentage)))
        self._gen = anytime_matrix_profile(np.asarray(T, np.float64),
                                           config=MatrixProfileConfig(m=m, device=device),
                                           batches=batches)
        self._exhausted = False
        w = np.asarray(T).shape[0] - m + 1
        self.P_ = np.full(w, np.inf)
        self.I_ = np.full(w, -1, np.int64)

    def update(self):
        if self._exhausted:
            return
        try:
            MP, MPI, _ = next(self._gen)
        except StopIteration:
            self._exhausted = True
            return
        self.P_ = np.asarray(MP, np.float64)
        self.I_ = np.asarray(MPI, np.int64)


class stimp:
    """stumpy.stimp: pan matrix profile — each :meth:`update` reveals
    one more window length (ascending); read ``PAN_`` (the normalized
    surface, NaN above unrevealed lengths) and ``M_``.  Backed by the
    FUSED pan sweep: all lengths are computed in ONE sweep on the first
    update, so later updates are free.

    Divergence: STUMPY's default ``min_m`` is 3; the exclusion zone
    (m // 4) needs m >= 4, so ``min_m`` is clamped to 4.  Read ``M_``
    for the actual lengths — PAN_ rows always align with it."""

    def __init__(self, T, min_m: int = 3, max_m=None, step: int = 1,
                 percentage: float = 0.01, *, device: str = "cuda"):
        del percentage  # the fused sweep computes exact-schedule rows
        T = np.asarray(T, np.float64)
        n = T.shape[0]
        min_m = max(min_m, 4)  # documented divergence: clamped from 3
        if max_m is None:
            max_m = max(min_m, n // 4)
        self._T = T
        self._device = device
        self.M_ = np.arange(min_m, max_m + 1, step, dtype=np.int64)
        self._pan = None
        self._revealed = 0
        w = n - min_m + 1
        self.PAN_ = np.full((self.M_.shape[0], w), np.nan)

    def update(self):
        if self._pan is None:
            from mpx_torch.pan import compute_pan_profile

            # the pan reads its device from the config and ignores its m
            self._pan = compute_pan_profile(
                self._T, [int(m) for m in self.M_],
                config=MatrixProfileConfig(m=int(self.M_[0]), device=self._device))
        if self._revealed < self.M_.shape[0]:
            r = self._revealed
            self.PAN_[r] = self._pan.normalized[r]
            self._revealed += 1
