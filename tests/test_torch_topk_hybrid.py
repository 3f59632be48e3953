"""The float64 top-k hybrid of mpx_torch
(``hybrid.compute_topk_profile_f64_hybrid``, reached through
``topk.compute_topk_profile(kernel="hybrid")``), on the CPU, against mpx's
float64 top-k (its own hybrid) and the brute-force oracle of
``tests/test_topk.py``.

Tolerances: distances 1e-8, as mpx's tests; an index may differ from the
oracle's only where both neighbors are equidistant within 1e-8.  The
stage knobs (mpx's ``MPX_TOPK_*`` variables) are module constants of the
port, so each escalation stage is forced by patching them; every stage
must give the oracle's lists.
"""

import numpy as np
import pytest
import torch

import mpx
from mpx.topk import compute_topk_profile as mpx_topk
from mpx_torch import MatrixProfileConfig, hybrid
from mpx_torch.topk import compute_topk_profile
from mpx_torch.utils.profile import BenchmarkProfile
from tests.conftest import random_walk
from tests.test_topk import brute_force_topk

EPS = 1e-8


def _cfg(m, kernel="hybrid", dtype="float64"):
    return MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=64, chunk=128,
                               device="cpu")


def _motifs(copies: int, seed: int) -> np.ndarray:
    """``copies`` repeats of a sine motif under 1e-3 noise (mpx's tie-heavy
    series): every window has a plateau of near-equal neighbors."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal(24 * copies) * 1e-3
    for r in range(copies):
        T[r * 24 : r * 24 + 24] += np.sin(np.linspace(0, 2 * np.pi, 24))
    return T


def _run(T, m, k, **kw):
    prof = BenchmarkProfile()
    D, I = compute_topk_profile(T, k=k, config=_cfg(m, **kw), profile=prof)
    assert D.dtype == torch.float64 and I.dtype == torch.int32
    return D.numpy(), I.numpy(), prof.counts


def assert_matches_oracle(T, m, k, D, I):
    De, Ie = brute_force_topk(T, m, k)
    assert D.shape == De.shape
    fin = np.isfinite(De)
    np.testing.assert_array_equal(np.isfinite(D), fin)
    np.testing.assert_allclose(D[fin], De[fin], rtol=0, atol=EPS)
    assert (I[~fin] == -1).all()
    # An index may differ only between equidistant neighbors: the oracle's
    # full distance row holds the listed index at the listed distance.
    from mpx.reference import znormalized_distance_matrix

    Dm = znormalized_distance_matrix(T, m)
    r, j = np.nonzero((I != Ie) & fin)
    np.testing.assert_allclose(Dm[r, I[r, j]], De[r, j], rtol=0, atol=EPS)
    assert np.all(np.diff(np.where(fin, D, np.finfo(np.float64).max), axis=1) >= -1e-12)


@pytest.mark.parametrize("n,m,k", [(300, 16, 4), (512, 32, 8), (256, 8, 1)])
def test_topk_hybrid_matches_mpx_and_brute_force(n, m, k):
    T = random_walk(n, seed=n + k)
    D, I, counts = _run(T, m, k)
    assert counts["pass_b"] == "sparse"
    assert_matches_oracle(T, m, k, D, I)
    Dr, Ir = mpx_topk(T, k=k, config=mpx.MatrixProfileConfig(
        m=m, dtype="float64", band=64, chunk=128, tile_rows=8, tile_cols=8))
    np.testing.assert_allclose(D, np.asarray(Dr), rtol=0, atol=EPS)
    diff = I != np.asarray(Ir)
    assert np.all(np.abs(D[diff] - np.asarray(Dr)[diff]) <= EPS)


def test_topk_hybrid_tie_heavy():
    """Repeated motifs overflow the capture slots: the plateau brackets and
    pass C resolve rows, and the lists stay exact."""
    T, m, k = _motifs(40, 17), 16, 4
    D, I, counts = _run(T, m, k)
    assert sum(counts["resolved_narrow"]) + sum(counts["resolved_pass_c"]) > 0, counts
    assert_matches_oracle(T, m, k, D, I)


SERIES = {"40 motifs": (lambda: _motifs(40, 29), 16),
          "12 motifs": (lambda: _motifs(12, 3), 16),
          "walk": (lambda: random_walk(1000, seed=2), 16)}


@pytest.mark.parametrize("knobs,series,stage", [
    ({"TOPK_K1": 8, "TOPK_K2": 64, "TOPK_RUNCAP": 8}, "40 motifs", "pass_c_wide"),
    ({"TOPK_K1": 8, "TOPK_K2": 16, "TOPK_RUNCAP": 8}, "40 motifs", "row_scan"),
    ({"TOPK_K1": 8, "TOPK_K2": 0, "TOPK_RUNCAP": 8}, "40 motifs", "row_scan"),
    ({}, "40 motifs", "pass_c"),
    ({}, "12 motifs", "narrow"),
    ({"TOPK_RUNCAP": 8}, "12 motifs", "pass_c"),
    ({"TOPK_MAX_IT": 1}, "walk", "row_scan"),
])
def test_topk_hybrid_escalation_stages(monkeypatch, knobs, series, stage):
    """Each escalation stage, forced at a toy size by lowering its knob
    (mpx forces them with MPX_TOPK_K1/K2/RUNCAP): the rows it resolves get
    the oracle's lists.  A tie plateau spans every copy of a motif: 40
    copies are wider than the plateau bracket, 12 are not.  TOPK_K2 = 0
    goes from pass C straight to the exact scan; TOPK_MAX_IT = 1 hands the
    rows left after one round to it."""
    for name, value in knobs.items():
        monkeypatch.setattr(hybrid, name, value)
    make, m = SERIES[series]
    T, k = make(), 4
    D, I, counts = _run(T, m, k)
    assert sum(counts[f"resolved_{stage}"]) > 0, counts
    assert counts["rounds"] <= hybrid.TOPK_MAX_IT
    assert_matches_oracle(T, m, k, D, I)


@pytest.mark.parametrize("cap", [1e-4, 8e-3, 1e9])
def test_topk_hybrid_seed_clamp(monkeypatch, cap):
    """The clamp of the seeded threshold (mpx's MPX_TOPK_CAP) moves rows
    between rounds, never results: unclamped (1e9), the k-th job maximum
    seeds every row and one round resolves them all; clamped tight
    (1e-4), the rows descend over several rounds."""
    monkeypatch.setattr(hybrid, "TOPK_CAP", cap)
    T, m, k = random_walk(1000, seed=2), 16, 4
    D, I, counts = _run(T, m, k)
    if cap == 1e9:
        assert counts["rounds"] == 1, counts
    if cap == 1e-4:
        assert counts["rounds"] > 1, counts
    assert_matches_oracle(T, m, k, D, I)


def test_topk_hybrid_spread_neighbors_descend():
    """Rows whose k-th neighbor lies far below the best: the threshold
    descends over several rounds (mpx's spread-neighbors case)."""
    T = np.cumsum(np.random.default_rng(23).standard_normal(700))
    m, k = 24, 6
    D, I, counts = _run(T, m, k)
    assert counts["rounds"] > 1, counts
    assert_matches_oracle(T, m, k, D, I)


def test_topk_hybrid_dense_route_gives_the_sparse_lists(monkeypatch):
    """With the capture gate closed, every round's pass B is dense and no
    seed estimate is made; the lists are the sparse route's, zero-variance
    windows (no neighbor at all) included.  Without the seed a row may
    settle in another stage, whose exact float64 sum rounds apart: 1e-12."""
    T, m, k = random_walk(400, seed=5), 16, 4
    T[100:140] = T[100]
    D, I, counts = _run(T, m, k)
    monkeypatch.setattr(hybrid, "SPARSE_MAX_W", 1)
    Dd, Id, counts_d = _run(T, m, k)
    assert counts["pass_b"] == "sparse" and counts_d["pass_b"] == "dense"
    assert counts_d["capture_bytes"] == 0
    np.testing.assert_allclose(D, Dd, rtol=0, atol=1e-12)
    assert (I == -1).any()
    assert_matches_oracle(T, m, k, D, I)
    assert_matches_oracle(T, m, k, Dd, Id)


@pytest.mark.parametrize("k,dtype", [(12, "float64"), (4, "float32")])
def test_topk_hybrid_routes_to_the_strict_tile(monkeypatch, k, dtype):
    """kernel="hybrid" with k > 2 * SUSPECT_K, or in float32, takes the
    strict tile, as mpx routes it: the lists equal kernel="auto"'s."""
    def refuse(*args, **kwargs):
        raise AssertionError("the hybrid ran")

    monkeypatch.setattr(hybrid, "compute_topk_profile_f64_hybrid", refuse)
    T = random_walk(256, seed=3)
    D, I = compute_topk_profile(T, k=k, config=_cfg(16, dtype=dtype))
    Da, Ia = compute_topk_profile(T, k=k, config=_cfg(16, kernel="auto", dtype=dtype))
    np.testing.assert_array_equal(D.numpy(), Da.numpy())
    np.testing.assert_array_equal(I.numpy(), Ia.numpy())


def test_topk_hybrid_rejects_k_out_of_range():
    T = random_walk(256, seed=4)
    for k in (0, 2 * hybrid.SUSPECT_K + 1):
        with pytest.raises(ValueError, match="hybrid top-k requires"):
            hybrid.compute_topk_profile_f64_hybrid(T, k, _cfg(16))


def test_job_kth_max_matches_a_numpy_fold():
    """Each position's k largest job maxima from pass A's captures, against
    a plain fold over the jobs in numpy."""
    T, m, S, W, k = random_walk(700, seed=8), 16, 64, 128, 4
    w = T.shape[0] - m + 1
    stats, _ = hybrid.hybrid_statistics(T, m, band=S, chunk=W, device="cpu")
    grid = hybrid.make_job_grid(w, S, W)
    _, cap = hybrid.run_max_jobs(stats, grid.r0, grid.k0, hybrid.default_margin(m), S=S,
                                 W=W, m=m, w=w, pw=stats.mu.shape[0])
    monkey = hybrid._KTH_GROUP
    try:
        hybrid._KTH_GROUP = 5  # several groups
        got = hybrid._job_kth_max(cap, k, w + S + W).numpy()
    finally:
        hybrid._KTH_GROUP = monkey
    r0s, k0s, jrow, jcol = (np.asarray(x) for x in cap)
    lists = [[] for _ in range(w + S + W)]
    for r0, k0, rv, cv in zip(r0s, k0s, jrow, jcol):
        for i, v in enumerate(rv):
            lists[r0 + i].append(v)
        for j, v in enumerate(cv):
            lists[r0 + k0 + j].append(v)
    want = np.full((w + S + W, k), hybrid.AGGREGATE_INIT, np.float32)
    for p, vals in enumerate(lists):
        top = sorted(vals, reverse=True)[:k]
        want[p, : len(top)] = top
    np.testing.assert_array_equal(got, want)


def test_row_topk_scan_orders_ties_by_index():
    """The exact scan keeps each row's k best over all valid pairs, equal
    values in ascending index order, across column blocks."""
    T, m, k = np.tile(np.random.default_rng(3).integers(-8, 9, 40).astype(float), 12), 16, 5
    w = T.shape[0] - m + 1
    _, exact = hybrid.hybrid_statistics(T, m, band=64, chunk=64, device="cpu")
    rows = torch.arange(0, w, 7)
    old = hybrid._SCAN_COLS
    try:
        hybrid._SCAN_COLS = 48  # several column blocks
        v, i = hybrid._row_topk_scan(exact.T, exact.mu[:w], exact.inv[:w], m, w, m // 4,
                                     rows, k)
    finally:
        hybrid._SCAN_COLS = old
    De, Ie = brute_force_topk(T, m, k)
    D = np.sqrt(np.maximum(2.0 * m * (1.0 - v.numpy()), 0.0))
    np.testing.assert_allclose(D, De[rows.numpy()], rtol=0, atol=1e-6)
    # Exact repeats tie bit for bit: the copies come in index order.
    np.testing.assert_array_equal(i.numpy(), Ie[rows.numpy()])
