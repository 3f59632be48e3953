"""The multi-dimensional profile of mpx_torch (``mpx_torch.mstamp``, on the
CPU) against mpx's ``compute_multidim_profile`` and the brute-force
``mstamp_oracle`` of ``tests/test_mstamp.py`` on the same seeded inputs.

Tolerances are the repo's: 2e-3 (float32) / 1e-8 (float64) on distances;
an index may differ only where both neighbors are equidistant.
"""

import numpy as np
import pytest

import mpx
from mpx.mstamp import compute_multidim_profile as mpx_mstamp
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch import mstamp
from mpx_torch.mstamp import (
    compute_multidim_profile,
    multidim_discord,
    multidim_mdl,
    multidim_motif,
    multidim_subspace,
)
from mpx_torch.reference import compute_matrix_profile_reference
from tests.test_mstamp import assert_multiprofile_close, mstamp_oracle

TOL = {"float32": 2e-3, "float64": 1e-8}


def _cfg(m, dtype="float64", **kw):
    return MatrixProfileConfig(**{"m": m, "dtype": dtype, "band": 32, "chunk": 64,
                                  "device": "cpu", **kw})


def _mpx(T, m, dtype="float64", **kw):
    return mpx_mstamp(T, config=mpx.MatrixProfileConfig(m=m, dtype=dtype, band=32, chunk=64),
                      **kw)


def _walks(d, n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal((d, n)), axis=1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mstamp_matches_oracle_and_mpx(dtype):
    T = _walks(3, 230, 31)
    m = 16
    prof = compute_multidim_profile(T, config=_cfg(m, dtype))
    assert prof.PMP.shape == (3, 230 - m + 1) and prof.PMPI.dtype == np.int32
    assert prof.PMP.dtype == np.dtype(dtype)
    assert_multiprofile_close(prof, *mstamp_oracle(T, m), TOL[dtype])
    ref = _mpx(T, m, dtype)
    assert_multiprofile_close(prof, ref.PMP.astype(np.float64), ref.PMPI, TOL[dtype])


def test_mstamp_d1_equals_the_1d_profile():
    T = np.cumsum(np.random.default_rng(37).standard_normal(400))
    m = 24
    prof = compute_multidim_profile(T[None, :], config=_cfg(m, band=64, chunk=64))
    MP, MPI = compute_matrix_profile(T, config=_cfg(m, band=64, chunk=64))
    np.testing.assert_allclose(prof.PMP[0], MP.numpy(), rtol=0, atol=1e-8)
    gMP, gMPI = compute_matrix_profile_reference(T, m)
    np.testing.assert_allclose(prof.PMP[0], gMP, rtol=0, atol=1e-8)
    mism = prof.PMPI[0] != gMPI
    np.testing.assert_allclose(prof.PMP[0][mism], gMP[mism], rtol=0, atol=1e-8)


def test_mstamp_flat_dimension_drops_out():
    """A constant dimension has +inf distance: the k = d profile is +inf
    with index -1 everywhere, and the k < d profiles ignore it."""
    n, m = 200, 16
    T = np.stack([np.cumsum(np.random.default_rng(41).standard_normal(n)), np.zeros(n)])
    prof = compute_multidim_profile(T, config=_cfg(m))
    assert not np.isfinite(prof.PMP[1]).any() and (prof.PMPI[1] == -1).all()
    assert_multiprofile_close(prof, *mstamp_oracle(T, m), 1e-8)
    ref = _mpx(T, m)
    np.testing.assert_allclose(prof.PMP, ref.PMP, rtol=0, atol=1e-8)


@pytest.mark.parametrize("include,discords", [((2,), False), ((), True), ((0, 3), True)])
def test_mstamp_include_and_discords(include, discords):
    T = _walks(4, 200, 61)
    T[:, 110:126] += np.random.default_rng(62).standard_normal((4, 16)) * 12
    m = 16
    prof = compute_multidim_profile(T, config=_cfg(m), include=list(include) or None,
                                    discords=discords)
    assert_multiprofile_close(prof, *mstamp_oracle(T, m, include=include, discords=discords),
                              1e-8)
    ref = _mpx(T, m, include=list(include) or None, discords=discords)
    assert_multiprofile_close(prof, ref.PMP, ref.PMPI, 1e-8)
    if discords:
        i, dist = multidim_discord(prof, k=4)
        ri, rdist = mpx.multidim_discord(ref, 4)
        assert i == ri and abs(dist - rdist) <= 1e-8


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mstamp_sub_bands_give_identical_outputs(monkeypatch, dtype):
    """A byte budget below one job's (d, S, W) tile cuts the job's rows
    into sub-bands (here 64 rows of a 96-row band, then a ragged 32): the
    outputs are bit-equal to the uncut run, with the zone and the ragged
    edge inside the cut jobs.  (Sub-bands of whole 32-row panels: the
    CPU's BLAS then gives each row the bits it has in the whole band's
    product.)"""
    T = _walks(3, 400, 59)
    T[1, 100:140] = 3.0  # a flat segment in one dimension
    cfg = _cfg(16, dtype, band=96, chunk=64)
    whole = compute_multidim_profile(T, config=cfg)
    monkeypatch.setattr(mstamp, "_TILE_BYTES", 3 * 64 * 64 * np.dtype(dtype).itemsize)
    cut = compute_multidim_profile(T, config=cfg)
    np.testing.assert_array_equal(cut.PMP, whole.PMP)
    np.testing.assert_array_equal(cut.PMPI, whole.PMPI)


def test_mstamp_fixed_point_input_is_the_quantized_series():
    from mpx_torch.io.apfixed import quantize

    T = _walks(2, 220, 43) * 0.01
    q = compute_multidim_profile(T, config=_cfg(16, "ap16"))
    e = compute_multidim_profile(quantize(T, "ap16"), config=_cfg(16, "float32"))
    np.testing.assert_array_equal(q.PMP, e.PMP)
    np.testing.assert_array_equal(q.PMPI, e.PMPI)


def test_motif_and_discord_helpers_match_mpx():
    rng = np.random.default_rng(47)
    d, n, m = 2, 240, 16
    T = np.cumsum(rng.standard_normal((d, n)), axis=1)
    pat = np.cumsum(rng.standard_normal((d, m)), axis=1)
    T[:, 30 : 30 + m] = pat
    T[:, 150 : 150 + m] = pat
    prof = compute_multidim_profile(T, config=_cfg(m))
    i, j, dist = multidim_motif(prof, k=d)
    assert {i, j} == {30, 150} and dist < 1e-6
    assert (i, j) == mpx.multidim_motif(_mpx(T, m), d)[:2]
    flat = np.stack([T[0], np.zeros(n)])
    with pytest.raises(ValueError, match="no valid pairs"):
        multidim_motif(compute_multidim_profile(flat, config=_cfg(m)), k=2)
    with pytest.raises(ValueError, match="no valid pairs"):
        multidim_discord(compute_multidim_profile(flat, config=_cfg(m), discords=True), k=2)


@pytest.mark.parametrize("kwargs", [dict(), dict(include=[0]), dict(discords=True),
                                    dict(include=[0, 2])])
def test_multidim_subspace_matches_mpx(kwargs):
    rng = np.random.default_rng(41)
    T = rng.standard_normal((4, 300))
    T[2, :] = 1e6 + 1e-5 * rng.standard_normal(300)  # numerically flat
    for k in range(1, 5):
        got = multidim_subspace(T, 32, 10, 150, k, **kwargs)
        np.testing.assert_array_equal(got, mpx.multidim_subspace(T, 32, 10, 150, k, **kwargs))
    with pytest.raises(ValueError, match="out of range"):
        multidim_subspace(T, 32, 300, 0, k=2)
    with pytest.raises(ValueError, match="k="):
        multidim_subspace(T, 32, 10, 150, k=9)


def test_multidim_mdl_matches_mpx():
    rng = np.random.default_rng(9)
    d, n, m = 4, 400, 32
    T = np.cumsum(rng.standard_normal((d, n)), axis=1)
    pat0 = np.sin(np.linspace(0, 4 * np.pi, m)) * 4
    pat1 = np.cos(np.linspace(0, 6 * np.pi, m)) * 4
    for pos in (60, 260):
        T[0, pos : pos + m] = pat0 + 0.01 * rng.standard_normal(m)
        T[1, pos : pos + m] = pat1 + 0.01 * rng.standard_normal(m)
    T[3] = 5.0  # a flat dimension can never justify itself
    res = multidim_mdl(T, m, config=_cfg(m))
    ref = mpx.multidim_mdl(T, m, config=mpx.MatrixProfileConfig(m=m, dtype="float64",
                                                                band=32, chunk=64))
    assert res.best_k == ref.best_k == 2
    np.testing.assert_array_equal(res.bitsaves, ref.bitsaves)
    assert res.motifs == ref.motifs
    for a, b in zip(res.subspaces, ref.subspaces):
        assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(ValueError, match="bits"):
        multidim_mdl(T, m, profile=compute_multidim_profile(T, config=_cfg(m)), bits=0)
    with pytest.raises(ValueError, match="rows"):
        multidim_mdl(T[:2], m, profile=compute_multidim_profile(T, config=_cfg(m)))


@pytest.mark.parametrize("case,match", [
    ("transposed", "transpose"), ("3d", "expected"), ("include", "out of range"),
    ("kernel", "one kernel"), ("nan", "non-finite"), ("m", "conflicts"),
])
def test_mstamp_value_errors(case, match):
    T = _walks(2, 120, 137)
    kw = dict(config=_cfg(16))
    if case == "transposed":
        T = T.T
    elif case == "3d":
        T = T[None]
    elif case == "include":
        kw["include"] = [5]
    elif case == "kernel":
        kw["config"] = _cfg(16, kernel="pallas")
    elif case == "nan":
        T[1, 60] = np.nan
    elif case == "m":
        kw["m"] = 24
    with pytest.raises(ValueError, match=match):
        compute_multidim_profile(T, **kw)
