"""Multi-series clustering under MPdist.

Counterpart of ``mpx/cluster.py``.  Whole series are compared by the
subsequences they share (MPdist), robust to misalignment:

* the k x k distance matrix comes from C(k,2) AB-joins
  (:func:`mpx_torch.analysis.mpdist`, K1 on the card), each pair giving
  both directional profiles in one sweep;
* agglomerative clustering (single / complete / average linkage) runs on
  the host over the k x k matrix, a Lance-Williams update in O(k^3) numpy;
* each cluster reports its medoid (the member with the smallest sum of
  within-cluster distances) and radius.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for


def mpdist_matrix(
    series: Sequence,
    m: Optional[int] = None,
    *,
    threshold: float = 0.05,
    config: Optional[MatrixProfileConfig] = None,
) -> np.ndarray:
    """Symmetric k x k MPdist matrix over ``series`` (two or more 1-D
    arrays, lengths may differ): one AB-join per unordered pair, the
    diagonal 0."""
    from mpx_torch.analysis import mpdist

    config = config_for(m, config)
    k = len(series)
    if k < 2:
        raise ValueError("mpdist_matrix needs at least two series")
    series = [np.asarray(s) for s in series]
    D = np.zeros((k, k), np.float64)
    for i in range(k):
        for j in range(i + 1, k):
            D[i, j] = D[j, i] = mpdist(series[i], series[j], config.m,
                                       threshold=threshold, config=config)
    return D


_LINKAGES = ("single", "complete", "average")


def hierarchical_cluster(
    D: np.ndarray,
    n_clusters: int,
    *,
    linkage: str = "average",
) -> np.ndarray:
    """Agglomerative clustering of a precomputed distance matrix down to
    ``n_clusters`` groups.  Returns integer labels in [0, n_clusters),
    numbered by first member.  Ties merge the lexicographically smallest
    (i, j) pair."""
    if linkage not in _LINKAGES:
        raise ValueError(f"linkage must be one of {_LINKAGES}")
    D = np.asarray(D, np.float64)
    k = D.shape[0]
    if D.shape != (k, k):
        raise ValueError("D must be square")
    if not (1 <= n_clusters <= k):
        raise ValueError(f"n_clusters must be in [1, {k}]")
    if not np.allclose(D, D.T, equal_nan=True):
        raise ValueError("D must be symmetric")

    W = D.copy()
    np.fill_diagonal(W, np.inf)
    alive = np.ones(k, bool)
    size = np.ones(k, np.int64)
    member = [[i] for i in range(k)]
    for _ in range(k - n_clusters):
        # argmin over the flat matrix: the smallest (i, j) among ties
        M = np.where(alive[:, None] & alive[None, :], W, np.inf)
        i, j = sorted(divmod(int(M.argmin()), k))
        if not np.isfinite(M[i, j]):
            raise ValueError("distance matrix has no finite merge left")
        # Lance-Williams update of row i (the surviving cluster)
        if linkage == "single":
            new = np.minimum(W[i], W[j])
        elif linkage == "complete":
            new = np.maximum(W[i], W[j])
        else:  # average (UPGMA)
            new = (size[i] * W[i] + size[j] * W[j]) / (size[i] + size[j])
        W[i], W[:, i] = new, new
        W[i, i] = np.inf
        alive[j] = False
        size[i] += size[j]
        member[i].extend(member[j])

    labels = np.empty(k, np.int64)
    for label, i in enumerate(sorted((i for i in range(k) if alive[i]),
                                     key=lambda i: min(member[i]))):
        labels[member[i]] = label
    return labels


class Cluster(NamedTuple):
    label: int
    members: List[int]
    medoid: int         # member minimizing the within-cluster distance sum
    radius: float       # max distance from the medoid to a member


class ClusterResult(NamedTuple):
    labels: np.ndarray          # per-series cluster label
    clusters: List[Cluster]
    distances: np.ndarray       # the k x k MPdist matrix


def summarize_clusters(D: np.ndarray, labels: np.ndarray) -> List[Cluster]:
    """Per-cluster medoid and radius from a distance matrix and labels."""
    D = np.asarray(D, np.float64)
    labels = np.asarray(labels)
    out: List[Cluster] = []
    for lbl in np.unique(labels):
        idx = np.nonzero(labels == lbl)[0]
        med = int(idx[D[np.ix_(idx, idx)].sum(axis=1).argmin()])
        out.append(Cluster(int(lbl), idx.tolist(), med, float(D[med, idx].max())))
    return out


def cluster_series(
    series: Sequence,
    m: Optional[int] = None,
    *,
    n_clusters: int = 2,
    linkage: str = "average",
    threshold: float = 0.05,
    config: Optional[MatrixProfileConfig] = None,
) -> ClusterResult:
    """MPdist matrix over ``series`` (AB-joins on ``config.device``), then
    hierarchical clustering and per-cluster medoids on the host."""
    D = mpdist_matrix(series, m, threshold=threshold, config=config)
    labels = hierarchical_cluster(D, n_clusters, linkage=linkage)
    return ClusterResult(labels, summarize_clusters(D, labels), D)
