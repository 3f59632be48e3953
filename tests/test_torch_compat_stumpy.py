"""mpx_torch's STUMPY shim (``mpx_torch/compat/stumpy.py``) against
mpx's (``mpx/compat/stumpy.py``), function for function, on the same
inputs: float32 within 2e-3 (the default precision of both), float64
within 1e-8, indices equal or equidistant; host functions equal."""

import numpy as np
import pytest

import mpx.compat.stumpy as ref
import mpx_torch.compat.stumpy as st
from tests.conftest import random_walk
from tests.helpers import assert_profile_close

CPU = {"device": "cpu"}
T = random_walk(600, seed=21)
B = random_walk(400, seed=24)
M = 16


@pytest.fixture(scope="module")
def stumped():
    """mpx's and the port's ``stump`` of T (the default float32 tier)."""
    return st.stump(T, M, **CPU), ref.stump(T, M)


def _profile_cols(got, want, Tx, m, tol, cols=(0, 1)):
    p, i = cols
    assert got.shape == want.shape and got.dtype == object
    assert_profile_close(Tx, m, got[:, p].astype(np.float64), got[:, i].astype(np.int64),
                         want[:, p].astype(np.float64), want[:, i].astype(np.int64), eps=tol)


def test_stump_equals_mpxs(stumped):
    got, want = stumped
    _profile_cols(got, want, T, M, 2e-3)
    # the left and right indices: equal, or an equidistant tie
    for c in (2, 3):
        gi, wi = got[:, c].astype(np.int64), want[:, c].astype(np.int64)
        assert ((gi >= 0) == (wi >= 0)).all() and (gi == wi).mean() > 0.99


def test_stump_ab_topk_and_raw_equal_mpxs():
    got, want = st.stump(T, M, B, **CPU), ref.stump(T, M, B)
    np.testing.assert_allclose(got[:, 0].astype(float), want[:, 0].astype(float), atol=2e-3)
    assert (got[:, 2] == -1).all() and (got[:, 3] == -1).all()
    got, want = st.stump(T, M, k=3, **CPU), ref.stump(T, M, k=3)
    assert got.shape == want.shape == (585, 8)
    np.testing.assert_allclose(got[:, :3].astype(float), want[:, :3].astype(float), atol=2e-3)
    got, want = st.stump(T, M, normalize=False, **CPU), ref.stump(T, M, normalize=False)
    d, w = got[:, 0].astype(float), want[:, 0].astype(float)
    assert np.abs(d - w).max() <= 2e-4 * w.max()  # mpx's raw float32 tolerance


def test_aliases_equal_stump(stumped):
    got, _ = stumped
    assert (st.stumped(None, T, M, **CPU) == got).all()
    assert (st.gpu_stump(T, M, device_id=3, **CPU) == got).all()
    Tm = np.cumsum(np.random.default_rng(35).standard_normal((2, 300)), axis=1)
    P1, I1 = st.mstump(Tm, 12, **CPU)
    P2, I2 = st.mstumped(None, Tm, 12, **CPU)
    np.testing.assert_array_equal(P1, P2)
    np.testing.assert_array_equal(I1, I2)


@pytest.mark.parametrize("call,err", [
    (lambda: st.stump(T, 8, p=1.0, **CPU), NotImplementedError),
    (lambda: st.stump(T, 8, ignore_trivial=False, **CPU), ValueError),
    (lambda: st.stump(T, 8, B, normalize=False, **CPU), NotImplementedError),
    (lambda: st.stump(T, 8, B, k=2, **CPU), NotImplementedError),
    (lambda: st.aamp(T, 8, ignore_trivial=False, **CPU), ValueError),
    (lambda: st.stumpi(T, 16, normalize=False, **CPU), NotImplementedError),
    (lambda: st.stumpi(T, 16, k=2, **CPU), NotImplementedError),
    (lambda: st.stumpi(T, 16, p=1.0, **CPU), NotImplementedError),
    (lambda: st.floss(None, T, 16, 32, **CPU), NotImplementedError),
    (lambda: st.scrump(T, 16, pre_scrimp=True, **CPU), NotImplementedError),
    (lambda: st.aampdist(T, B, 16, p=1.0, **CPU), NotImplementedError),
])
def test_refusals_are_mpxs(call, err):
    with pytest.raises(err):
        call()


def test_aamp_and_aampdist_equal_mpxs():
    got, want = st.aamp(T, 12, **CPU), ref.aamp(T, 12)
    d, w = got[:, 0].astype(float), want[:, 0].astype(float)
    assert np.abs(d - w).max() <= 2e-4 * w.max()
    assert (got[:, 2] == -1).all()
    A2, B2 = random_walk(300, seed=44), random_walk(260, seed=45)
    assert st.aampdist(A2, B2, 24, **CPU) == pytest.approx(ref.aampdist(A2, B2, 24), abs=1e-3)


def test_host_functions_equal_mpxs(stumped):
    """mass, match, motifs, fluss, atsc and allc run on the host: the
    same inputs give mpx's indices, and its distances within 1e-6 (at a
    distance of 0, sqrt(2m(1 - P)) turns one rounding of P into ~1e-7)."""
    got, want = stumped
    np.testing.assert_allclose(st.mass(T[:16], T), ref.mass(T[:16], T), atol=1e-6)
    a, b = st.match(T[100:116], T), ref.match(T[100:116], T)
    np.testing.assert_array_equal(a[:, 1], b[:, 1])
    np.testing.assert_allclose(a[:, 0].astype(float), b[:, 0].astype(float), atol=1e-6)
    P = want[:, 0].astype(float)
    (d1, i1), (d2, i2) = (f.motifs(T, P, max_motifs=2, max_matches=5) for f in (st, ref))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    Iw = want[:, 1].astype(np.int64)
    for a, b in zip(st.fluss(Iw, 16, n_regimes=3), ref.fluss(Iw, 16, n_regimes=3)):
        np.testing.assert_array_equal(a, b)
    IL, IR = want[:, 2].astype(np.int64), want[:, 3].astype(np.int64)
    np.testing.assert_array_equal(st.atsc(IL, IR, 5), ref.atsc(IL, IR, 5))
    (S1, C1), (S2, C2) = st.allc(IL, IR), ref.allc(IL, IR)
    assert len(S1) == len(S2) and all((a == b).all() for a, b in zip(S1, S2))
    np.testing.assert_array_equal(C1, C2)


def test_floss_equals_mpxs():
    a, b = st.floss(None, T, 16, 16, **CPU), ref.floss(None, T, 16, 16)
    pts = np.random.default_rng(0).standard_normal(50).cumsum() + T[-1]
    a.append(pts)
    b.append(pts)
    np.testing.assert_allclose(a.cac(), b.cac(), atol=2e-3)


def test_mstump_and_subspace_equal_mpxs():
    Tm = np.cumsum(np.random.default_rng(29).standard_normal((3, 400)), axis=1)
    P, I = st.mstump(Tm, 12, **CPU)
    Pw, Iw = ref.mstump(Tm, 12)
    assert P.shape == (3, 389) and I.dtype == np.int64
    np.testing.assert_allclose(P, Pw, atol=2e-3)
    assert (I == Iw).mean() > 0.99
    np.testing.assert_array_equal(st.subspace(Tm, 12, 10, int(Iw[1, 10]), 1),
                                  ref.subspace(Tm, 12, 10, int(Iw[1, 10]), 1))


def test_mmotifs_equals_mpxs():
    rng = np.random.default_rng(9)
    d, n, m = 4, 600, 32
    Tm = np.cumsum(rng.standard_normal((d, n)), axis=1)
    pat0 = np.sin(np.linspace(0, 4 * np.pi, m)) * 4
    pat1 = np.cos(np.linspace(0, 6 * np.pi, m)) * 4
    for pos in (100, 400):
        Tm[0, pos : pos + m] = pat0 + 0.01 * rng.standard_normal(m)
        Tm[1, pos : pos + m] = pat1 + 0.01 * rng.standard_normal(m)
    P, I = ref.mstump(Tm, m)
    for kw in ({"max_motifs": 2, "max_matches": 4}, {"k": 2, "max_motifs": 1}):
        got, want = st.mmotifs(Tm, P, I, **kw), ref.mmotifs(Tm, P, I, **kw)
        np.testing.assert_allclose(got[0], want[0], atol=1e-8)
        np.testing.assert_array_equal(got[1], want[1])
        assert [s.tolist() for s in got[2]] == [s.tolist() for s in want[2]]
        assert [None if b is None else np.asarray(b).tolist() for b in got[3]] \
            == [None if b is None else np.asarray(b).tolist() for b in want[3]]
    assert set(st.mmotifs(Tm, P, I, max_motifs=1)[2][0].tolist()) == {0, 1}


def test_snippets_ostinato_mpdist_equal_mpxs():
    sv, si, sf = st.snippets(T, 50, 2, **CPU)
    rv, ri, rf = ref.snippets(T, 50, 2)
    np.testing.assert_array_equal(si, ri)
    np.testing.assert_array_equal(sv, rv)
    np.testing.assert_allclose(sf, rf, atol=1e-6)
    series = [T, B, random_walk(350, seed=32)]
    r, tsi, ssi = st.ostinato(series, 16, **CPU)
    rr, rtsi, rssi = ref.ostinato(series, 16)
    assert (tsi, ssi) == (rtsi, rssi) and r == pytest.approx(rr, abs=2e-3)
    assert st.mpdist(T, B, 16, **CPU) == pytest.approx(ref.mpdist(T, B, 16), abs=2e-3)


def test_scrump_and_stimp_equal_mpxs():
    T4 = random_walk(400, seed=33)
    a, b = st.scrump(T4, 16, percentage=0.25, **CPU), ref.scrump(T4, 16, percentage=0.25)
    prev = np.full_like(a.P_, np.inf)
    for _ in range(6):
        a.update()
        b.update()
        assert (a.P_ <= prev + 1e-9).all()  # anytime: monotone
        prev = a.P_.copy()
    assert_profile_close(T4, 16, a.P_, a.I_, b.P_, b.I_, eps=2e-3)  # exhausted: exact
    a, b = st.stimp(T4, 8, 24, 8, **CPU), ref.stimp(T4, 8, 24, 8)
    np.testing.assert_array_equal(a.M_, b.M_)
    for _ in range(2):
        a.update()
        b.update()
        np.testing.assert_allclose(a.PAN_, b.PAN_, atol=2e-3)  # NaN rows agree too


def test_stumpi_equals_mpxs():
    T5 = random_walk(560, seed=41)
    m = 32
    for egress in (False, True):
        a = st.stumpi(T5[:384], m, egress=egress, **CPU)
        b = ref.stumpi(T5[:384], m, egress=egress)
        for t in T5[384:420]:
            a.update(t)  # scalar appends (the STUMPY contract)
            b.update(t)
        a.update(T5[420:])  # an array append (the extension)
        b.update(T5[420:])
        np.testing.assert_array_equal(a.T_, b.T_)
        Tv = a.T_ if not egress else T5
        if not egress:
            assert_profile_close(Tv, m, a.P_, a.I_, b.P_, b.I_, eps=2e-3)
        np.testing.assert_allclose(a.P_, b.P_, atol=2e-3)
        np.testing.assert_allclose(a.left_P_, b.left_P_, atol=2e-3)
        assert ((a.left_I_ >= 0) == (b.left_I_ >= 0)).all()
