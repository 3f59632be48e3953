"""MPdist clustering of mpx_torch (``mpx_torch.cluster``, on the CPU)
against mpx's ``mpx.cluster``.

The MPdist matrix comes from each package's AB-joins: within 1e-8
(float64) / 2e-3 (float32).  The clustering is host numpy over a given
matrix: both packages get the same one and agree exactly.
"""

import numpy as np
import pytest

import mpx
import mpx.cluster as mpx_cluster
from mpx_torch import MatrixProfileConfig, cluster
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
M = 32


def _families(seed=91):
    """Two families of series: each member shares noisy segments with its
    family's template."""
    rng = np.random.default_rng(seed)
    out = []
    for fam in range(2):
        base = random_walk(1500, seed=seed + 10 * fam)
        for j in range(3):
            T = random_walk(700 + 100 * j, seed=seed + 10 * fam + 1 + j)
            for k, at in enumerate((50, 350)):
                src = 200 * (k + j) + 100
                T[at : at + 200] = T[at] - base[src] + base[src : src + 200] \
                    + 0.05 * rng.standard_normal(200)
            out.append(T)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mpdist_matrix_within_tolerance_of_mpxs(dtype):
    series = _families()[:4]
    D = cluster.mpdist_matrix(series, config=MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512, device="cpu"), threshold=0.1)
    E = mpx_cluster.mpdist_matrix(series, config=mpx.MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512), threshold=0.1)
    assert D.shape == (4, 4) and (np.diag(D) == 0).all()
    np.testing.assert_array_equal(D, D.T)
    np.testing.assert_allclose(D, E, rtol=0, atol=EPS[dtype])


@pytest.mark.parametrize("linkage", ["single", "complete", "average"])
@pytest.mark.parametrize("n_clusters", [1, 2, 3, 5])
def test_hierarchical_cluster_equals_mpxs(linkage, n_clusters):
    rng = np.random.default_rng(93)
    X = rng.random((7, 7))
    D = X + X.T
    np.fill_diagonal(D, 0)
    D[1, 4] = D[4, 1] = D[2, 6] = D[6, 2] = 0.01  # a tie
    labels = cluster.hierarchical_cluster(D, n_clusters, linkage=linkage)
    np.testing.assert_array_equal(
        labels, mpx_cluster.hierarchical_cluster(D, n_clusters, linkage=linkage))
    assert sorted(set(labels.tolist())) == list(range(n_clusters))
    assert cluster.summarize_clusters(D, labels) == mpx_cluster.summarize_clusters(D, labels)


def test_cluster_series_finds_the_families():
    series = _families()
    res = cluster.cluster_series(series, n_clusters=2, threshold=0.1,
                                 config=MatrixProfileConfig(m=M, dtype="float64", band=256,
                                                            chunk=512, device="cpu"))
    ref = mpx_cluster.cluster_series(series, n_clusters=2, threshold=0.1,
                                     config=mpx.MatrixProfileConfig(
                                         m=M, dtype="float64", band=256, chunk=512))
    np.testing.assert_array_equal(res.labels, [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(res.labels, ref.labels)
    np.testing.assert_allclose(res.distances, ref.distances, rtol=0, atol=EPS["float64"])
    assert [(c.label, c.members, c.medoid) for c in res.clusters] == \
        [(c.label, c.members, c.medoid) for c in ref.clusters]
    for a, b in zip(res.clusters, ref.clusters):
        assert abs(a.radius - b.radius) <= EPS["float64"]


def test_refusals_match_mpxs():
    D = np.array([[0.0, 1.0], [2.0, 0.0]])
    for mod in (cluster, mpx_cluster):
        with pytest.raises(ValueError, match="linkage"):
            mod.hierarchical_cluster(np.zeros((2, 2)), 1, linkage="ward")
        with pytest.raises(ValueError, match="symmetric"):
            mod.hierarchical_cluster(D, 1)
        with pytest.raises(ValueError, match="n_clusters"):
            mod.hierarchical_cluster(np.zeros((2, 2)), 3)
    with pytest.raises(ValueError, match="at least two"):
        cluster.mpdist_matrix([random_walk(100)], config=MatrixProfileConfig(m=16,
                                                                            device="cpu"))
