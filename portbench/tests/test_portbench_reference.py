"""The plain reference against a brute-force profile, the comparison's tie
rule, and the roofline's arithmetic."""

import numpy as np
import pytest

from portbench import check, files, roofline
from portbench.reference import exact_rows as ref
from portbench.readings import Request, Run
from portbench.trace import Trace

CONFIG = {"m": 8, "tolerance": 1e-8, "reference": "exact_rows"}


def brute(T, m):
    """O(w^2 m) loops: z-normalized distances, the first index of the
    nearest neighbour outside the zone, -1 where there is none."""
    w = len(T) - m + 1
    Z = []
    for i in range(w):
        x = T[i:i + m]
        c = x - x.mean()
        s = np.sqrt((c * c).sum())
        Z.append(None if s * s <= 1e-10 * (x * x).sum() else c / s)
    mp, mpi = np.full(w, np.inf), np.full(w, -1)
    for i in range(w):
        for j in range(w):
            if abs(i - j) < m // 4 or Z[i] is None or Z[j] is None:
                continue
            d = np.sqrt(max(2 * m * (1 - float(Z[i] @ Z[j])), 0.0))
            if d < mp[i] - 1e-12:
                mp[i], mpi[i] = d, j
    return mp, mpi


def series(kind, n=160, seed=3):
    g = np.random.default_rng(seed)
    T = np.cumsum(g.standard_normal(n))
    if kind == "ties":  # a copied stretch: every window that finds its
        T[120:160] = T[80:120]  # neighbour in it finds two, equidistant
    if kind == "flat":  # constant windows have no neighbour
        T[40:70] = 5.0
    return T


@pytest.mark.parametrize("kind", ["walk", "ties", "flat"])
def test_reference_matches_brute_force(kind):
    T = series(kind)
    m = CONFIG["m"]
    w = len(T) - m + 1
    best, idx, _ = ref.exact_rows(T, m, np.arange(w))
    mp, mpi = brute(T, m)
    live = np.isfinite(mp)
    np.testing.assert_array_equal(np.isfinite(best), live)
    # An exact repeat's distance is rounding: sqrt(2 m eps), ~1e-7.
    np.testing.assert_allclose(ref.distance(m, best[live]), mp[live],
                               atol=1e-6 if kind == "ties" else 1e-9)
    if kind != "ties":  # with ties the first index may differ by rounding
        np.testing.assert_array_equal(idx, mpi)
    assert (idx[~live] == -1).all()


def test_limited_columns_are_the_best_over_the_earlier_windows():
    T = series("walk")
    m, w = CONFIG["m"], len(T) - CONFIG["m"] + 1
    rows = np.arange(100, w)
    _, _, lim = ref.exact_rows(T, m, rows, col_limit=rows + 1)
    for r, v in zip(rows, lim):
        b, _, _ = ref.exact_rows(T[: r + m], m, np.array([r]))
        assert v == pytest.approx(b[0], abs=1e-13)


def test_comparison_takes_equidistant_indices_and_refuses_others():
    T = series("ties")
    m, w = CONFIG["m"], len(T) - CONFIG["m"] + 1
    rows = np.arange(w)
    best, mpi, _ = ref.exact_rows(T, m, rows)
    mp = ref.distance(m, best)
    assert check.compare_rows(files.ROOT, CONFIG, T, rows, mp, mpi, device="cpu").index_bad == 0
    # rows outside the copies whose neighbour lies in the first copy have
    # the same neighbour, equidistant, 40 windows on
    tied = [r for r in range(w) if 80 <= mpi[r] <= 112 and abs(r - mpi[r] - 40) >= m // 4
            and not 72 <= r <= 160]
    assert tied
    alt = mpi.copy()
    alt[tied] += 40
    t = check.compare_rows(files.ROOT, CONFIG, T, rows, mp, alt, device="cpu")
    assert (t.index_bad, t.dist_err) == (0, 0.0)
    wrong = mpi.copy()
    wrong[5] = (wrong[5] + 37) % w
    assert check.compare_rows(files.ROOT, CONFIG, T, rows, mp, wrong, device="cpu").index_bad == 1
    far = mp.copy()
    far[7] += 1e-7
    t = check.compare_rows(files.ROOT, CONFIG, T, rows, far, mpi, device="cpu")
    assert not t.within(CONFIG)
    short = check.compare_rows(files.ROOT, CONFIG, T, rows, mp[:-3], mpi[:-3], device="cpu")
    assert short.index_bad == 3 and not short.within(CONFIG)


def test_pair_counts_follow_the_shapes():
    assert roofline.pairs(1 << 20, 256) == 549_487_935_360
    w = (1 << 20) - 255
    assert roofline.pairs_outside_zone(1 << 20, 256) == (w - 64) * (w - 63) // 2
    for n, m in ((300, 16), (1024, 32)):
        w = n - m + 1
        assert roofline.pairs(n, m) == sum(w - 1 - i for i in range(w))
        assert roofline.pairs_outside_zone(n, m) == sum(
            1 for i in range(w) for j in range(i + m // 4, w))


def test_least_time_is_the_arithmetic_bound_at_the_showcase():
    t = roofline.least_seconds(1 << 20, 256, "float64")
    assert t == pytest.approx(4 * roofline.pairs_outside_zone(1 << 20, 256) / 67e12)
    assert 0.0327 < t < 0.0329


def _run(names, seconds):
    t = Trace(window_s=10.0, busy_s=sum(seconds), kernel_s=sum(seconds), kernels=len(names),
              device_ops=[[n, s] for n, s in zip(names, seconds)], idle_gaps=[])
    req = Request(kind="selfjoin", t0=0.0, t1=7.0, n=1 << 20, m=256, dtype="float64")
    return Run(workload="w", config={}, traffic={}, setup_s=1.0, window=(0.0, 7.0),
               requests=[req], trace=t)


def test_sweep_roofline_reads_the_same_whatever_kernel_ran():
    read = files.module(files.ROOT, "metrics", "sweep_roofline").read
    k1 = read(_run(["k1_tiles<double, false>", "k1_reduce<double>"], [6.8, 0.2]))
    k3 = read(_run(["k3_band<double>", "k3_segsum", "k3_reduce"], [6.0, 0.5, 0.5]))
    assert k1 == k3 == pytest.approx(100 * roofline.least_seconds(1 << 20, 256, "float64") / 7.0)
    assert read(_run([], [])) is None
