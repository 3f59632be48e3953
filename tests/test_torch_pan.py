"""The pan profile of mpx_torch (``mpx_torch.pan`` and its fused sweep
``mpx_torch.pan_kernel``, on the CPU) against mpx's ``compute_pan_profile``
on the same seeded inputs, the port's single-m profiles and the numpy
golden.

Tolerances: the fused (float32) surface within 2e-3 of mpx's fused surface
and of the exact per-m profiles (mpx's own, ``tests/test_pan.py``); the
exact surface equal to the port's ``compute_matrix_profile`` per length.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mpx
from mpx.pan import PanProfile as MpxPanProfile
from mpx.pan import pan_discords as mpx_pan_discords
from mpx.pan import pan_motifs as mpx_pan_motifs
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.pan import (
    PanProfile,
    compute_pan_profile,
    pan_discords,
    pan_m_range,
    pan_motifs,
)
from mpx_torch.pan_kernel import run_pan_jobs
from mpx_torch.reference import compute_matrix_profile_reference
from mpx_torch.utils.profile import BenchmarkProfile
from tests.conftest import random_walk
from tests.helpers import assert_profile_close


def _cfg(m, dtype="float32", **kw):
    return MatrixProfileConfig(**{"m": m, "dtype": dtype, "band": 128, "chunk": 256,
                                  "device": "cpu", **kw})


def test_fused_matches_mpx_fused_and_the_exact_profiles():
    T = random_walk(900, seed=31)
    ms = [16, 23, 32, 48, 64]
    pan = compute_pan_profile(T, ms, config=_cfg(16), method="fused")
    ref = mpx.compute_pan_profile(T, ms, config=mpx.MatrixProfileConfig(
        m=16, band=128, chunk=256), method="fused")
    n = T.shape[0]
    assert pan.PMP.shape == (5, n - 16 + 1) and pan.PMP.dtype == np.float64
    assert pan.PMPI.dtype == np.int32
    np.testing.assert_array_equal(pan.ms, ref.ms)
    for r, m in enumerate(ms):
        wm = n - m + 1
        assert_profile_close(T, m, pan.PMP[r, :wm], pan.PMPI[r, :wm], ref.PMP[r, :wm],
                             ref.PMPI[r, :wm], eps=2e-3)
        MPg, MPIg = compute_matrix_profile_reference(T, m)
        assert_profile_close(T, m, pan.PMP[r, :wm], pan.PMPI[r, :wm], MPg, MPIg, eps=2e-3)
        assert np.isinf(pan.PMP[r, wm:]).all() and (pan.PMPI[r, wm:] == -1).all()


def test_exact_rows_equal_the_single_m_profiles():
    T = random_walk(600, seed=13)
    ms = [16, 24, 48]
    cfg = _cfg(16, "float64", band=64, chunk=128)
    pan = compute_pan_profile(T, ms, config=cfg)  # auto: float64 -> exact
    for r, m in enumerate(ms):
        MP, MPI = compute_matrix_profile(T, config=dataclasses.replace(cfg, m=m))
        wm = 600 - m + 1
        np.testing.assert_array_equal(pan.PMP[r, :wm], MP.numpy())
        np.testing.assert_array_equal(pan.PMPI[r, :wm], MPI.numpy())
        assert np.isinf(pan.PMP[r, wm:]).all() and (pan.PMPI[r, wm:] == -1).all()


def test_fused_degenerate_windows_stay_unmatched():
    """Constant stretches (zero variance) match nothing and are nobody's
    neighbor at every level, as in mpx's surface."""
    T = random_walk(700, seed=33)
    T[200:340] = 5.0
    ms = [16, 32]
    pan = compute_pan_profile(T, ms, config=_cfg(16, band=64, chunk=128), method="fused")
    ref = mpx.compute_pan_profile(T, ms, config=mpx.MatrixProfileConfig(
        m=16, band=64, chunk=128), method="fused")
    for r, m in enumerate(ms):
        w = 700 - m + 1
        const = np.array([np.ptp(T[i : i + m]) == 0 for i in range(w)])
        assert (pan.PMPI[r, :w][const] == -1).all()
        matched = pan.PMPI[r, :w][~const]
        assert not np.isin(matched[matched >= 0], np.nonzero(const)[0]).any()
        np.testing.assert_array_equal(pan.PMPI[r, :w] >= 0, ref.PMPI[r, :w] >= 0)


def test_fused_multi_level_panel_wider_than_128():
    """Levels that cross mpx's 128-column raw-panel block (the port slices
    one unfold instead) stay within 2e-3 of the golden."""
    T = random_walk(1000, seed=71)
    ms = [96, 128, 150, 257]
    pan = compute_pan_profile(T, ms, config=_cfg(96), method="fused")
    for r, m in enumerate(ms):
        MPg, MPIg = compute_matrix_profile_reference(T, m)
        wm = 1000 - m + 1
        assert_profile_close(T, m, pan.PMP[r, :wm], pan.PMPI[r, :wm], MPg, MPIg, eps=2e-3)


def test_run_pan_jobs_returns_tensors_and_profiles_its_phases():
    T = random_walk(500, seed=3)
    prof = BenchmarkProfile()
    PMP, PMPI = run_pan_jobs(T, [8, 12, 16], band=64, chunk=128, device="cpu", profile=prof)
    assert PMP.dtype == torch.float64 and PMPI.dtype == torch.int32
    assert PMP.shape == PMPI.shape == (3, 500 - 8 + 1)
    assert list(prof.category_totals()) == ["1. Pre-Computation [pan host]",
                                            "2. Compute [pan x3 levels]",
                                            "3. Post-Computation [pan]"]
    with pytest.raises(ValueError, match="ascending"):
        run_pan_jobs(T, [16, 8], band=64, chunk=128, device="cpu")


def _surface():
    rng = np.random.default_rng(21)
    T = rng.standard_normal(900)
    pat = np.cumsum(rng.standard_normal(60))
    pat = (pat - pat.mean()) / pat.std() * 3
    T[100:160] += pat
    T[500:560] += pat
    return compute_pan_profile(T, [16, 32, 56], config=_cfg(16, "float64", band=64,
                                                                 chunk=128))


def test_normalized_motifs_and_discords_match_mpx_on_the_same_surface():
    pan = _surface()
    ref = MpxPanProfile(ms=pan.ms, PMP=pan.PMP, PMPI=pan.PMPI)
    np.testing.assert_array_equal(pan.normalized, ref.normalized)
    assert pan_motifs(pan, k=3) == [tuple(x) for x in mpx_pan_motifs(ref, k=3)]
    assert pan_discords(pan, k=3) == [tuple(x) for x in mpx_pan_discords(ref, k=3)]
    top = pan_motifs(pan, k=1)[0]
    assert 95 <= top.a and top.a + top.m <= 165 and abs((top.b - top.a) - 400) <= 4


def test_pan_m_range_matches_mpx_and_its_errors():
    np.testing.assert_array_equal(pan_m_range(8, 512, 10), mpx.pan_m_range(8, 512, 10))
    np.testing.assert_array_equal(pan_m_range(64, 8192, 8), 64 * 2 ** np.arange(8))
    for lo, hi in ((2, 64), (64, 8)):
        with pytest.raises(ValueError):
            pan_m_range(lo, hi)
    cfg = _cfg(16)
    with pytest.raises(ValueError, match="no pairs"):
        compute_pan_profile(random_walk(64), [64], config=cfg)
    with pytest.raises(ValueError, match="empty"):
        compute_pan_profile(random_walk(64), [], config=cfg)
    with pytest.raises(ValueError, match="method"):
        compute_pan_profile(random_walk(64), [8], config=cfg, method="skimp")


def test_pan_without_a_config_takes_the_card(monkeypatch):
    """No config: the fused surface on ``cuda`` (which raises without a
    card; nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_pan_profile(random_walk(300), [8, 16])


def test_fixed_point_input_is_quantized_once_for_both_methods():
    from mpx_torch.io.apfixed import quantize

    T = random_walk(400, seed=5) * 0.01
    ms = [16, 24]
    q = compute_pan_profile(T, ms, config=_cfg(16, "ap16"), method="fused")
    e = compute_pan_profile(quantize(T, "ap16"), ms, config=_cfg(16), method="fused")
    np.testing.assert_array_equal(q.PMP, e.PMP)
    qx = compute_pan_profile(T, ms, config=_cfg(16, "ap32"))  # float64 -> exact
    ex = compute_pan_profile(quantize(T, "ap32"), ms, config=_cfg(16, "float64"))
    np.testing.assert_array_equal(qx.PMP, ex.PMP)
    assert isinstance(qx, PanProfile)
