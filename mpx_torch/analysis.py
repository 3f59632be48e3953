"""Matrix-profile analysis helpers: motifs, discords, segmentation,
guided search, chains, MPdist and similarity search.

Counterpart of ``mpx/analysis.py``.  All of it is numpy over profiles
that the port's tiers computed, except:

* :func:`mpdist`, which runs the port's AB-join
  (:func:`mpx_torch.abjoin.compute_ab_join`: K1 on the card);
* :func:`mass` / :func:`match`, one query's distance profile on the host
  in float64 (FFT or blocked BLAS dots), as in mpx: one query row is host
  work there too, and a batch of queries is an AB-join.

Motifs are the lowest-distance mutually-nearest pairs and discords the
highest-distance windows, each suppressing ``max(m // 4, m // 2)``
neighbors; the corrected arc curve (FLUSS) dips at regime boundaries
(FLOSS, :mod:`mpx_torch.floss`, scores its streaming right profile with
:func:`one_directional_cac`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from mpx_torch.reference import exclusion_zone


class Motif(NamedTuple):
    a: int
    b: int
    distance: float


class Discord(NamedTuple):
    index: int
    distance: float


class Match(NamedTuple):
    index: int
    distance: float


def _host(x) -> np.ndarray:
    """A profile as a host array (a tensor on any device, or array-like)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _suppress(mask: np.ndarray, center: int, zone: int):
    lo = max(0, center - zone)
    mask[lo : center + zone + 1] = False


def top_motifs(MP, MPI, m: int, k: int = 3) -> List[Motif]:
    """k lowest-distance motif pairs, each suppressing an m/2 zone."""
    MP = np.asarray(_host(MP), dtype=np.float64).copy()
    MPI = _host(MPI)
    zone = max(exclusion_zone(m), m // 2)
    alive = np.isfinite(MP) & (MPI >= 0)
    out: List[Motif] = []
    while len(out) < k and alive.any():
        i = int(np.where(alive, MP, np.inf).argmin())
        if not np.isfinite(MP[i]):
            break
        j = int(MPI[i])
        out.append(Motif(min(i, j), max(i, j), float(MP[i])))
        _suppress(alive, i, zone)
        _suppress(alive, j, zone)
    return out


def top_discords(MP, MPI, m: int, k: int = 3) -> List[Discord]:
    """k highest-distance subsequences (anomalies)."""
    MP = np.asarray(_host(MP), dtype=np.float64)
    MPI = _host(MPI)
    zone = max(exclusion_zone(m), m // 2)
    alive = np.isfinite(MP) & (MPI >= 0)
    out: List[Discord] = []
    while len(out) < k and alive.any():
        i = int(np.where(alive, MP, -np.inf).argmax())
        if not alive[i]:
            break
        out.append(Discord(i, float(MP[i])))
        _suppress(alive, i, zone)
    return out


def corrected_arc_curve(MPI, m: int) -> np.ndarray:
    """FLUSS corrected arc curve (CAC) from the profile index.

    For each position i, counts the nearest-neighbor arcs (j <-> MPI[j])
    spanning i (an O(n) +1/-1 sweep) and normalizes by the idealized
    parabola 2*i*(w-i)/w of boundary-free data.  Values near 1 mean as
    many crossings as random; dips toward 0 mark regime boundaries.  The
    first/last m positions are pinned to 1."""
    MPI = np.asarray(MPI)
    w = MPI.shape[0]
    src = np.nonzero(MPI >= 0)[0]
    dst = MPI[src]
    i = np.arange(w, dtype=np.float64)
    ideal = 2.0 * i * (w - i) / w
    return _arc_curve(np.minimum(src, dst), np.maximum(src, dst), ideal, m, w)


def _arc_curve(lo, hi, ideal, m: int, w: int) -> np.ndarray:
    """Shared CAC scaffolding: count arcs [lo, hi) spanning each position
    with a +1/-1 delta sweep, normalize by the null-model ``ideal`` curve,
    cap at 1, and pin the first/last min(m, w//2) positions."""
    delta = np.zeros(w + 1, np.float64)
    np.add.at(delta, lo, 1.0)
    np.add.at(delta, hi, -1.0)
    crossings = np.cumsum(delta[:-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        cac = np.where(ideal > 0, crossings / ideal, 1.0)
    cac = np.minimum(cac, 1.0)
    edge = min(m, w // 2)
    cac[:edge] = 1.0
    cac[w - edge:] = 1.0
    return cac


def one_directional_cac(MPI_right, m: int) -> np.ndarray:
    """One-directional corrected arc curve (the FLOSS variant) from the
    RIGHT profile index: every arc points from a window to its nearest
    LATER neighbor, so the curve can be kept over a growing or sliding
    stream.

    Under the null model (each source j points to a uniformly random
    destination in (j, w-1]) the expected number of arcs spanning i is

        E[c_i] = (w-1-i) * (H_{w-1} - H_{w-2-i}),   H_k = sum_{t<=k} 1/t

    Windows without a right neighbor (MPI_right < 0) contribute no arc.
    The first/last m positions are pinned to 1."""
    MPI_right = np.asarray(MPI_right)
    w = MPI_right.shape[0]
    src = np.nonzero(MPI_right > np.arange(w))[0]
    dst = MPI_right[src]
    H = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, w, dtype=np.float64))])
    r = w - 1 - np.arange(w)
    ideal = r * (H[w - 1] - H[np.maximum(r - 1, 0)])
    return _arc_curve(src, dst, ideal, m, w)


def extract_regimes(cac: np.ndarray, m: int, k: int = 1) -> List[int]:
    """k regime-change locations from a corrected arc curve: the k lowest
    valleys, each suppressing a 5*m zone (the FLUSS rule)."""
    cac = np.asarray(cac, np.float64).copy()
    zone = 5 * m
    out: List[int] = []
    while len(out) < k:
        i = int(cac.argmin())
        if not np.isfinite(cac[i]) or cac[i] >= 1.0:
            break
        out.append(i)
        lo = max(0, i - zone)
        cac[lo : i + zone + 1] = np.inf
    return out


def regimes(MPI, m: int, k: int = 1) -> List[int]:
    """k regime-change locations: the k lowest CAC valleys, each
    suppressing a 5*m zone."""
    return extract_regimes(corrected_arc_curve(MPI, m), m, k=k)


def apply_annotation_vector(MP, AV, mode: str = "motif") -> np.ndarray:
    """Guided matrix profile (Matrix Profile V): bias the profile by a
    per-window annotation vector AV in [0, 1],

        motif:   CMP[i] = MP[i] + (1 - AV[i]) * max(MP_finite)
        discord: CMP[i] = MP[i] - (1 - AV[i]) * max(MP_finite)

    so a window with AV = 0 never wins the chosen search; AV = 1 leaves it
    untouched."""
    MP = np.asarray(_host(MP), np.float64)
    AV = np.asarray(AV, np.float64)
    if AV.shape != MP.shape:
        raise ValueError(f"annotation vector shape {AV.shape} != profile {MP.shape}")
    if AV.min() < 0 or AV.max() > 1:
        raise ValueError("annotation vector values must lie in [0, 1]")
    if mode not in ("motif", "discord"):
        raise ValueError("mode must be 'motif' or 'discord'")
    finite = np.isfinite(MP)
    peak = MP[finite].max() if finite.any() else 0.0
    sign = 1.0 if mode == "motif" else -1.0
    return np.where(finite, MP + sign * (1.0 - AV) * peak, MP)


def complexity_annotation(T, m: int) -> np.ndarray:
    """Complexity annotation vector (favors windows with structure over
    flat ones): the root sum of squared first differences per window,
    scaled to [0, 1]."""
    T = np.asarray(T, np.float64)
    d2 = np.diff(T) ** 2
    c = np.concatenate([[0.0], np.cumsum(d2)])
    ce = np.sqrt(c[m - 1 :] - c[: -(m - 1)])
    lo, hi = ce.min(), ce.max()
    if hi - lo < 1e-300:
        return np.ones_like(ce)
    return (ce - lo) / (hi - lo)


def all_chains(MPI_left, MPI_right) -> List[List[int]]:
    """All-chain set (TSC17): a link i -> j exists iff j's nearest EARLIER
    neighbor is i and i's nearest LATER neighbor is j.  Chains are maximal
    link paths; every index belongs to exactly one chain (singletons
    included).  Inputs are the left/right profile indices of
    ``compute_matrix_profile(..., left_right=True)``."""
    from mpx_torch.chains import chain_links

    link = chain_links(_host(MPI_left), _host(MPI_right))
    w = link.shape[0]
    backlink = np.full(w, -1, np.int64)
    backlink[link[link >= 0]] = np.nonzero(link >= 0)[0]
    chains: List[List[int]] = []
    for h in np.nonzero(backlink < 0)[0]:
        chain = [int(h)]
        while link[chain[-1]] >= 0:
            chain.append(int(link[chain[-1]]))
        chains.append(chain)
    return chains


def unanchored_chain(MPI_left, MPI_right) -> np.ndarray:
    """The longest chain of the all-chain set (ties: earliest start)."""
    from mpx_torch.chains import anchored_chain, chain_lengths

    il, ir = _host(MPI_left), _host(MPI_right)
    lengths = chain_lengths(il, ir)
    return anchored_chain(il, ir, int(lengths.argmax()))


def mpdist_from_profiles(mp_a, mp_b, na: int, nb: int,
                         threshold: float = 0.05) -> float:
    """MPdist from already computed ABBA-join profiles: the k-th smallest
    value of concat(P_AB, P_BA) with ``k = ceil(threshold * (na + nb))``
    (the largest if fewer values)."""
    joined = np.concatenate([_host(mp_a), _host(mp_b)])
    joined = joined[np.isfinite(joined)]
    if joined.size == 0:
        return float("inf")
    k = int(np.ceil(threshold * (na + nb)))
    k = min(max(k, 1), joined.size)
    return float(np.partition(joined, k - 1)[k - 1])


def mpdist(A, B, m: int, *, threshold: float = 0.05, config=None) -> float:
    """MPdist: the series-to-series distance of the ABBA-join profiles,
    small when A and B share any subsequence.  Both directions come from
    one AB-join (:func:`mpx_torch.abjoin.compute_ab_join`, on
    ``config.device``)."""
    from mpx_torch.abjoin import compute_ab_join

    res = compute_ab_join(A, B, m=m, config=config)
    return mpdist_from_profiles(res.mp_a, res.mp_b, np.asarray(A).shape[0],
                                np.asarray(B).shape[0], threshold=threshold)


def mass(Q, T, method: str = "auto", normalize: bool = True) -> np.ndarray:
    """Distance profile of query ``Q`` against every window of ``T``
    (MASS), float64 on the host, length ``len(T) - len(Q) + 1``.

    ``method='fft'`` computes the sliding dot products in O(n log n),
    ``'direct'`` with blocked BLAS dots in O(n m), and ``'auto'`` takes
    direct up to n m = 2^26.  Flat windows of T get +inf; a flat query
    raises.  ``normalize=False`` returns raw Euclidean distances (the
    AAMP analog): flat windows and queries are valid there."""
    from mpx_torch.ops.precompute import ZERO_VARIANCE_REL, precompute_statistics_numpy

    Q = np.asarray(Q, np.float64)
    T = np.asarray(T, np.float64)
    if Q.ndim != 1 or T.ndim != 1:
        raise ValueError("mass expects 1-d query and series")
    m, n = Q.shape[0], T.shape[0]
    if m < 4:
        raise ValueError("query must have at least 4 points")
    if n < m:
        raise ValueError("series shorter than the query")
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"unknown method {method!r}")
    w = n - m + 1
    if not normalize:
        return _mass_raw(Q, T, m, n, w)

    s = precompute_statistics_numpy(T, m)
    inv = s["inv"]
    qc = Q - float(Q.mean())
    ssqQ = float(qc @ qc)
    if ssqQ <= ZERO_VARIANCE_REL * float(Q @ Q) or ssqQ == 0.0:
        raise ValueError("query has (numerically) zero variance; "
                         "z-normalized distance is undefined")
    invQ = 1.0 / np.sqrt(ssqQ)

    if method == "auto":
        method = "direct" if n * m <= (1 << 26) else "fft"
    # sum(qc) = 0, so qc's dot with a raw window is its dot with the
    # centered window: the doubly centered product.
    if method == "fft":
        L = 1
        while L < n + m:
            L <<= 1
        # correlation = convolution with the reversed query
        QT = np.fft.irfft(np.fft.rfft(T, L) * np.fft.rfft(qc[::-1], L), L)
        cdot = QT[m - 1 : m - 1 + w]
    else:
        windows = np.lib.stride_tricks.sliding_window_view(T, m)
        cdot = np.empty(w, np.float64)
        blk = 1 << 16
        for o in range(0, w, blk):
            cdot[o : o + blk] = windows[o : o + blk] @ qc
    P = cdot * invQ * inv
    with np.errstate(invalid="ignore"):
        D = np.sqrt(np.maximum(2.0 * m * (1.0 - np.clip(P, -1.0, 1.0)), 0.0))
    return np.where(np.isfinite(inv), D, np.inf)


def _mass_raw(Q, T, m, n, w):
    """Raw Euclidean distance profile (the AAMP analog of MASS): prefix
    sums of squares and blocked BLAS dots, both on copies centered by the
    joint mean for conditioning (D^2 = ssq_q + ssq_w - 2 dot does not
    change when both operands shift together)."""
    mu = float(np.concatenate([Q, T]).mean())
    Qc, Tc = Q - mu, T - mu
    ssq_q = float(Qc @ Qc)
    sq = np.concatenate([[0.0], np.cumsum(Tc * Tc)])
    ssq_w = sq[m:] - sq[:-m]
    wins = np.lib.stride_tricks.sliding_window_view(Tc, m)
    dot = np.empty(w, np.float64)
    blk = 1 << 16
    for o in range(0, w, blk):
        dot[o : o + blk] = wins[o : o + blk] @ Qc
    return np.sqrt(np.maximum(ssq_q + ssq_w - 2.0 * dot, 0.0))


def match(Q, T, *, max_distance=None, max_matches: Optional[int] = None,
          method: str = "auto", return_profile: bool = False):
    """All non-overlapping occurrences of ``Q`` in ``T``, nearest first.

    ``max_distance`` defaults to ``max(min(D), mean(D) - 2 std(D))`` over
    the finite profile; each match suppresses ``max(m // 4, m // 2)``
    neighbors on each side.  ``return_profile=True`` returns ``(matches,
    D)`` with the MASS profile they came from."""
    Q = np.asarray(Q, np.float64)
    m = Q.shape[0]
    D = mass(Q, T, method=method)
    finite = D[np.isfinite(D)]
    if finite.size == 0:
        return ([], D) if return_profile else []
    if max_distance is None:
        max_distance = float(max(finite.min(), finite.mean() - 2.0 * finite.std()))
    zone = max(exclusion_zone(m), m // 2)
    alive = np.isfinite(D)
    out: List[Match] = []
    while alive.any() and (max_matches is None or len(out) < max_matches):
        i = int(np.where(alive, D, np.inf).argmin())
        if not alive[i] or D[i] > max_distance:
            break
        out.append(Match(i, float(D[i])))
        _suppress(alive, i, zone)
    return (out, D) if return_profile else out
