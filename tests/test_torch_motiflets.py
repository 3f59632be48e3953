"""k-Motiflets of mpx_torch (``mpx_torch.motiflets``, on the CPU) against
mpx's ``mpx.motiflets``.

Both run their top-k profile (the port's strict tile, on the card as
well), then the same host search: on a walk with noisy planted copies
(no ties) the same windows, extents within 1e-8 (float64) / 2e-3
(float32; the extents themselves are exact float64 over the chosen
windows), the same elbows.  ``pairwise_extent`` is host float64 and
agrees exactly.
"""

import numpy as np
import pytest

import mpx
import mpx.motiflets as mpx_motiflets
from mpx_torch import MatrixProfileConfig, motiflets
from tests.conftest import random_walk

M = 32


@pytest.fixture(scope="module")
def planted():
    rng = np.random.default_rng(101)
    T = random_walk(3000, seed=102)
    shape = 4 * np.sin(np.linspace(0, 4 * np.pi, 48)) + np.cumsum(rng.standard_normal(48))
    for at in (300, 1000, 1700, 2400):
        T[at : at + 48] = T[at] + shape + 0.1 * rng.standard_normal(48)
    return T


def _cfgs(dtype):
    return (MatrixProfileConfig(m=M, dtype=dtype, band=512, chunk=1024, device="cpu"),
            mpx.MatrixProfileConfig(m=M, dtype=dtype, band=512, chunk=1024))


@pytest.mark.parametrize("dtype,k", [("float64", 3), ("float64", 4), ("float32", 4)])
def test_k_motiflets_equal_mpxs(planted, dtype, k):
    ours_cfg, ref_cfg = _cfgs(dtype)
    ours = motiflets.k_motiflets(planted, k, config=ours_cfg, candidates=16)
    ref = mpx_motiflets.k_motiflets(planted, k, config=ref_cfg, candidates=16)
    assert ours.k == ref.k == k
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert abs(ours.extent - ref.extent) <= 1e-12
    assert ours.extent == motiflets.pairwise_extent(planted, M, ours.indices)
    if k == 4:
        for at in (300, 1000, 1700, 2400):
            assert any(at <= i <= at + 48 - M for i in ours.indices)


def test_motiflet_elbows_equal_mpxs(planted):
    ours_cfg, ref_cfg = _cfgs("float64")
    res, elbows = motiflets.motiflet_elbows(planted, 6, config=ours_cfg, candidates=16)
    ref, ref_elbows = mpx_motiflets.motiflet_elbows(planted, 6, config=ref_cfg, candidates=16)
    assert [r.k for r in res] == [2, 3, 4, 5, 6]
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.indices, b.indices)
        assert abs(a.extent - b.extent) <= 1e-12
    assert elbows == ref_elbows and 4 in elbows


def test_wide_sets_take_host_mass_rows(planted):
    """k = 10 needs more neighbors than the 8-wide list: the seeds top up
    through host MASS rows, as in mpx."""
    ours_cfg, ref_cfg = _cfgs("float64")
    ours = motiflets.k_motiflets(planted, 10, config=ours_cfg, candidates=4)
    ref = mpx_motiflets.k_motiflets(planted, 10, config=ref_cfg, candidates=4)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.indices.shape == (10,) and abs(ours.extent - ref.extent) <= 1e-12


def test_pairwise_extent_equals_mpxs(planted):
    for idx in ([5, 900, 2000], [300, 1000, 1700, 2400], [17, 18]):
        assert motiflets.pairwise_extent(planted, M, idx) == \
            mpx_motiflets.pairwise_extent(planted, M, idx)


def test_refusals_match_mpxs():
    T = random_walk(300)
    for mod, cfg in zip((motiflets, mpx_motiflets), _cfgs("float64")):
        with pytest.raises(ValueError, match="k >= 2"):
            mod.k_motiflets(T, 1, config=cfg)
        with pytest.raises(ValueError, match="do not fit"):
            mod.k_motiflets(T, 40, config=cfg)
        with pytest.raises(ValueError, match="kmax"):
            mod.motiflet_elbows(T, 1, config=cfg)
