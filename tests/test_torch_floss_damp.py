"""FLOSS and DAMP in mpx_torch (``mpx_torch.floss``, ``mpx_torch.damp``,
``mpx_torch.analysis``, on the CPU) against mpx's on the same seeded
inputs: FLOSS's curve equal to mpx's at float64 and to the
one-directional CAC of the port's batch right profile of the retained
series; batch DAMP against the brute-force left profile (1e-8) and mpx's
``compute_damp``; the online detector's scores and alerts against the
batch and mpx's detector, on a planted anomaly.
"""

import numpy as np
import pytest

import mpx
from mpx import analysis as mpx_analysis
from mpx.damp import OnlineAnomalyDetector as MpxDetector
from mpx.damp import compute_damp as mpx_damp
from mpx.floss import Floss as MpxFloss
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.analysis import (
    corrected_arc_curve,
    extract_regimes,
    one_directional_cac,
    regimes,
)
from mpx_torch.damp import Anomaly, OnlineAnomalyDetector, compute_damp
from mpx_torch.floss import Floss
from tests.test_damp import with_anomaly
from tests.test_floss import two_regime_series
from tests.test_left_right import brute_force_left_right

CFG = dict(dtype="float64", band=64, chunk=128, tile_rows=8, tile_cols=16)


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _right_mpi(T, m):
    cfg = MatrixProfileConfig(m=m, dtype="float64", device="cpu")
    return compute_matrix_profile(T, config=cfg, left_right=True)[3].numpy()


def test_cac_functions_equal_mpx():
    T = two_regime_series()
    m = 32
    MPI = _right_mpi(T, m)
    np.testing.assert_array_equal(one_directional_cac(MPI, m),
                                  mpx_analysis.one_directional_cac(MPI, m))
    full = compute_matrix_profile(T, config=MatrixProfileConfig(m=m, device="cpu"))[1].numpy()
    cac = corrected_arc_curve(full, m)
    np.testing.assert_array_equal(cac, mpx_analysis.corrected_arc_curve(full, m))
    assert extract_regimes(cac, m, k=2) == mpx_analysis.extract_regimes(cac, m, k=2)
    assert regimes(full, m, k=1) == mpx_analysis.regimes(full, m, k=1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_floss_with_trims_equals_mpx_and_the_batch_cac(dtype):
    T = _walk(2000, 13)
    m = 32
    ours = Floss(T[:600], m, window=900, dtype=dtype, device="cpu")
    ref = MpxFloss(T[:600], m, window=900, dtype=dtype)
    for s in range(600, 2000, 111):
        ours.append(T[s : s + 111])
        ref.append(T[s : s + 111])
    assert ours.offset == ref.offset > 0  # at least one trim
    assert ours.offset + ours.series.shape[0] == 2000
    np.testing.assert_array_equal(ours.series, T[ours.offset :])
    if dtype == "float64":
        np.testing.assert_array_equal(ours.cac(), ref.cac())
        np.testing.assert_array_equal(ours.cac(),
                                      one_directional_cac(_right_mpi(ours.series, m), m))
    else:
        np.testing.assert_allclose(ours.cac(), ref.cac(), atol=0.05)
    MP, MPI = ours.profile()
    MPr, MPIr = ref.profile()
    fin = MPI >= 0
    np.testing.assert_array_equal(fin, MPIr >= 0)
    assert np.abs(MP[fin] - MPr[fin]).max() <= (1e-8 if dtype == "float64" else 2e-3)


def test_floss_finds_the_boundary_in_stream_positions():
    T = two_regime_series(n=2000, split=1400, seed=13)
    m = 32
    fl = Floss(T[:600], m, window=900, dtype="float64", device="cpu")
    for s in range(600, len(T), 111):
        fl.append(T[s : s + 111])
    (r,) = fl.regimes(k=1)
    assert abs(r - 1400) <= 2 * m
    assert fl.score < 1.0
    init = Floss(T[:1000], m, window=800, device="cpu")
    assert init.offset == 200
    with pytest.raises(ValueError, match="window"):
        Floss(T, m, window=20, device="cpu")
    with pytest.raises(ValueError, match="slack"):
        Floss(T, m, slack=1.0, device="cpu")


def test_batch_damp_matches_the_left_oracle_and_mpx():
    T = _walk(700, 9)
    res = compute_damp(T, config=MatrixProfileConfig(m=24, device="cpu", **CFG), k=3)
    bl, _, _, _ = brute_force_left_right(T, 24)
    fin = np.isfinite(bl)
    np.testing.assert_allclose(res.scores[fin], bl[fin], atol=1e-8)
    ref = mpx_damp(T, config=mpx.MatrixProfileConfig(m=24, **CFG), k=3)
    assert [a.index for a in res.discords] == [a.index for a in ref.discords]
    for a, b in zip(res.discords, ref.discords):
        assert a.distance == pytest.approx(b.distance, abs=1e-8)
    assert res.scores.dtype == np.float64 and res.split == 0


def test_batch_damp_finds_the_planted_anomaly():
    m = 32
    T = with_anomaly(m=m)
    res = compute_damp(T, config=MatrixProfileConfig(m=m, device="cpu", **CFG), split=100,
                       k=2)
    assert abs(res.discords[0].index - 700) <= m
    assert abs(res.discords[0].index - res.discords[1].index) >= m // 2
    with pytest.raises(ValueError, match="split"):
        compute_damp(T, config=MatrixProfileConfig(m=m, device="cpu", **CFG), split=5000)


@pytest.mark.parametrize("threshold", [None, 4.0])
def test_online_detector_equals_the_batch_and_mpx(threshold):
    m = 32
    T = with_anomaly(m=m)
    ours = OnlineAnomalyDetector(T[:300], config=MatrixProfileConfig(m=m, device="cpu",
                                                                     **CFG),
                                 threshold=threshold)
    ref = MpxDetector(T[:300], config=mpx.MatrixProfileConfig(m=m, **CFG),
                      threshold=threshold)
    alerts, ref_alerts = [], []
    for o in range(300, len(T), 97):
        alerts += ours.append(T[o : o + 97])
        ref_alerts += ref.append(T[o : o + 97])
    assert [a.index for a in alerts] == [a.index for a in ref_alerts]
    for a, b in zip(alerts, ref_alerts):
        assert isinstance(a, Anomaly) and a.distance == pytest.approx(b.distance, abs=1e-8)
    w = len(T) - m + 1
    batch = compute_damp(T, config=MatrixProfileConfig(m=m, device="cpu", **CFG))
    np.testing.assert_allclose(ours.scores(ours.split, w), batch.scores[ours.split :],
                               atol=1e-8)
    assert abs(ours.discord.index - 700) <= m
    if threshold is None:
        d = [a.distance for a in alerts]
        assert all(x < y for x, y in zip(d, d[1:])) and alerts[-1] == ours.discord
    else:
        assert alerts and all(a.distance > threshold for a in alerts)


def test_flat_windows_do_not_alert():
    m = 16
    T = np.random.default_rng(4).normal(0, 1, 300)
    det = OnlineAnomalyDetector(T, config=MatrixProfileConfig(m=m, device="cpu", **CFG))
    alerts = det.append(np.zeros(64))  # a constant tail: flat windows
    assert not [a for a in alerts if a.distance > np.sqrt(2 * m * (1 + 1e10))]
    assert det.append([]) == []
