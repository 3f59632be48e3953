"""mpx_torch on an NVIDIA GPU: K1 and K3 against their plain versions,
the self-join end to end against the numpy golden oracle, and the hybrid
tier on the card against the same code on the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor mpx, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1's band values 1e-5 (float32) / 1e-12 (float64), the two
sides summing m products in different orders.  K3 and its plain version
carry the recurrence's rounding down the band's rows, each in its own
order, and near-constant windows amplify it: each is held to the exact
recurrence of the same statistics (``K3_EXACT_TOL``, ``PLAIN_EXACT_TOL``),
and K3 in float64 to the plain version at 1e-12 away from them.
Distances 2e-3 / 1e-8, the repo's profile tolerances.  Indices may differ
only between ties.
"""

import numpy as np
import pytest
import torch

from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.kernels import mxu, mxu_fused, recurrence, xla
from mpx_torch.kernels.common import band_geometry
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.reference import band_recurrence_exact, compute_matrix_profile_reference

BAND_TOL = {"float32": 1e-5, "float64": 1e-12}
K3_BAND_TOL = {"float32": 1e-4, "float64": 1e-12}
# K3 and its plain version against the exact recurrence of the same
# statistics, beside near-constant windows: about three times the largest
# reading (PERF.md, PR 4).  K3 computes in float64 for float32 statistics
# too, so its float32 error is one rounding of its outputs.
K3_EXACT_TOL = {"float32": 1e-6, "float64": 1e-11}
PLAIN_EXACT_TOL = {"float32": 4e-3, "float64": 1e-11}
DIST_TOL = {"float32": 2e-3, "float64": 1e-8}
N, M, S, W = 2048, 64, 256, 512
W_PROFILE = N - M + 1
EDGE_JOBS = [(0, 0), (768, 0), (1792, 0), (1280, 512)]


def _series(n: int, seed: int, constant_run: bool = True) -> np.ndarray:
    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    if constant_run:
        T[n // 3 : n // 3 + 200] = T[n // 3]  # zero-variance windows
    return T


def _znorm_distance(T, m, i, j) -> float:
    a, b = T[i : i + m], T[j : j + m]
    a, b = (a - a.mean()) / a.std(), (b - b.mean()) / b.std()
    return float(np.sqrt(np.sum((a - b) ** 2)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K3 are CUDA kernels with no CPU mode")
    return torch.device("cuda")


def _assert_band_close(ours, ref, U64, r0, k0, tol):
    for side, base in (("row", r0), ("col", r0 + k0)):
        a, b = getattr(ours, side), getattr(ref, side)
        assert a.value.shape == b.value.shape, (r0, k0, side)
        err = (a.value.double() - b.value.double()).abs().max().item()
        assert err <= tol, (r0, k0, side, err)
        bad = torch.nonzero(a.index != b.index).flatten()
        assert bool(((a.index[bad] >= 0) & (b.index[bad] >= 0)).all())
        own = U64[base + bad]
        gap = ((own * U64[a.index[bad].long()]).sum(1)
               - (own * U64[b.index[bad].long()]).sum(1)).abs()
        assert bool((gap <= tol).all()), (r0, k0, side)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_matches_plain_on_card(card, dtype):
    stats = precompute_statistics(_series(N, 7), M, band=S, chunk=W, dtype=dtype,
                                  device=card)
    U64 = stats.windows.double()
    geom = band_geometry(S, W, M, W_PROFILE)
    launches = mxu_fused.LAUNCHES
    for r0, k0 in EDGE_JOBS:
        ours = mxu_fused.sweep_band_mxu_fused(stats, r0, k0, geom, dtype)
        ref = mxu.sweep_band_mxu(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        _assert_band_close(ours, ref, U64, r0, k0, BAND_TOL[dtype])
    assert mxu_fused.LAUNCHES == launches + len(EDGE_JOBS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [4, 37, 100, 256])
def test_k1_ragged_shapes_match_plain_on_card(card, dtype, m):
    """m off the MMA depth (and, at m = 37, rows off 16-byte boundaries);
    S and W off the 128 x 64 block tile; jobs on the exclusion zone, the
    constant run, rows past w-1 and columns past w-1."""
    n, band, chunk = 1700 + m, 200, 328
    w = n - m + 1
    T = _series(n, 13, constant_run=False)
    T[n // 3 : n // 3 + 400] = T[n // 3]  # zero-variance windows at every m here
    stats = precompute_statistics(T, m, band=band, chunk=chunk, dtype=dtype, device=card)
    U64 = stats.windows.double()
    geom = band_geometry(band, chunk, m, w)
    jobs = [(0, 0), (n // 3 - 100, 0), (n // 3 - 100, band), (w - band // 2, 0),
            (w - chunk - band // 2, chunk)]
    launches = mxu_fused.LAUNCHES
    for r0, k0 in jobs:
        ours = mxu_fused.sweep_band_mxu_fused(stats, r0, k0, geom, dtype)
        ref = mxu.sweep_band_mxu(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        _assert_band_close(ours, ref, U64, r0, k0, BAND_TOL[dtype])
    assert mxu_fused.LAUNCHES == launches + len(jobs)


def exact_band(stats, r0, k0, geom):
    """The band's exact recurrence on the same statistics
    (:func:`mpx_torch.reference.band_recurrence_exact`)."""
    f = lambda x: x.double().cpu().numpy()  # noqa: E731
    return band_recurrence_exact(f(stats.T), f(stats.mu), f(stats.df), f(stats.dg),
                                 f(stats.inv), int(r0), int(k0), geom.S, geom.W, geom.m,
                                 geom.w, geom.excl)


def assert_near_exact(out, exact, r0, k0, tol) -> float:
    """Band outputs within tol of the exact band's values (rounded to the
    outputs' type); an index other than the exact one picks a pair whose
    exact correlation ties the exact maximum within tol.  Returns the
    largest difference."""
    row_v, row_i, col_v, col_i, P = exact
    worst = 0.0
    for side, ev, ei in (("row", row_v, row_i), ("col", col_v, col_i)):
        v = getattr(out, side).value.cpu().numpy()
        idx = getattr(out, side).index.cpu().numpy()
        assert v.shape == ev.shape and idx.dtype == np.int32, (r0, k0, side)
        err = float(np.abs(v.astype(np.float64) - ev.astype(v.dtype)).max())
        assert err <= tol, (r0, k0, side, err)
        worst = max(worst, err)
        for k in np.nonzero(idx != ei)[0]:
            assert idx[k] >= 0 and ei[k] >= 0, (r0, k0, side, k, "masked vs unmasked")
            # Pair (band row i, diagonal j) of the index the output chose.
            i = k if side == "row" else idx[k] - r0
            j = idx[k] - (r0 + k0) - k if side == "row" else k - i
            assert abs(P[i, j] - ev[k]) <= tol, (r0, k0, side, k, "not a tie")
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [4, 37, 256])
@pytest.mark.parametrize("band,chunk", [(4096, 16384), (4096, 700), (1000, 16384),
                                        (1000, 700), (S, W)])
def test_k3_matches_plain_on_card(card, dtype, m, band, chunk):
    """Bands of one to sixteen row segments (1000 rows: a ragged last
    one), chunks on and off the kernel's 128-diagonal blocks, on a series
    with a constant run (zero-variance windows, and near-constant ones
    beside them whose large inverse norms amplify the recurrence's
    rounding); jobs on the first band, the exclusion zone over the
    constant run, rows past w-1 and columns past w-1.  K3 and the plain
    version (in the statistics' dtype) are each held to the exact
    recurrence of the same statistics; on the jobs away from the constant
    run K3 in float64 is also held to the plain version at 1e-12 (in
    float32 the plain version's own rounding passes 1e-4 even there at
    m = 4: PERF.md).  Prints the largest differences, the readings
    PERF.md derives the bounds from."""
    n = 4 * band + chunk + m
    w = n - m + 1
    T = _series(n, 7, constant_run=False)
    T[n // 3 : n // 3 + 400] = T[n // 3]  # zero-variance windows at every m here
    stats = precompute_statistics(T, m, band=band, chunk=chunk, dtype=dtype, device=card,
                                  windows=dtype == "float64")
    geom = band_geometry(band, chunk, m, w)
    jobs = [(0, 0), (n // 3 - band // 2, 0), (w - band // 2, 0),
            (w - chunk - band // 2, chunk)]
    launches = recurrence.LAUNCHES
    k3_err = plain_err = 0.0
    for r0, k0 in jobs:
        ours = recurrence.sweep_band_recurrence(stats, r0, k0, geom, dtype)
        ref = xla.sweep_band_xla(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        assert ours.col.value.shape == (band + chunk,)
        exact = exact_band(stats, r0, k0, geom)
        k3_err = max(k3_err, assert_near_exact(ours, exact, r0, k0, K3_EXACT_TOL[dtype]))
        plain_err = max(plain_err, assert_near_exact(ref, exact, r0, k0,
                                                     PLAIN_EXACT_TOL[dtype]))
        if dtype == "float64" and r0 >= n // 3 + 400:  # no near-constant window
            _assert_band_close(ours, ref, stats.windows.double(), r0, k0,
                               K3_BAND_TOL[dtype])
    assert recurrence.LAUNCHES == launches + len(jobs)
    print(f"\nK3 readings {dtype} m={m} band={band} chunk={chunk}: "
          f"K3 vs exact {k3_err:.3e}, plain vs exact {plain_err:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("left_right", [False, True])
def test_auto_profile_on_card_matches_golden(card, dtype, left_right):
    T = _series(3000, 11, constant_run=False)
    m = 32
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=256, chunk=512, device="cuda")
    calls, launches = mxu.CALLS, mxu_fused.LAUNCHES
    out = compute_matrix_profile(T, config=cfg, left_right=left_right)
    assert mxu.CALLS == calls and mxu_fused.LAUNCHES > launches
    assert all(o.device.type == "cuda" for o in out)
    out = [o.cpu().numpy() for o in out]
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    if left_right:
        # The nearer of the left and right neighbors is the profile.
        right_wins = out[2] < out[0]
        out = [np.where(right_wins, out[2], out[0]), np.where(right_wins, out[3], out[1])]
    MP, MPI = out
    np.testing.assert_allclose(MP, MP_exp, rtol=0, atol=DIST_TOL[dtype])
    for i in np.nonzero(MPI != MPI_exp)[0]:
        gap = _znorm_distance(T, m, i, MPI[i]) - _znorm_distance(T, m, i, MPI_exp[i])
        assert abs(gap) <= DIST_TOL[dtype], f"MPI[{i}] not an equidistant tie"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pallas_profile_on_card_matches_golden(card, dtype):
    T = _series(3000, 11, constant_run=False)
    m = 32
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel="pallas", band=256, chunk=512,
                              device="cuda")
    calls, launches = xla.CALLS, recurrence.LAUNCHES
    MP, MPI = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
    assert xla.CALLS == calls and recurrence.LAUNCHES > launches
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    np.testing.assert_allclose(MP, MP_exp, rtol=0, atol=DIST_TOL[dtype])
    for i in np.nonzero(MPI != MPI_exp)[0]:
        gap = _znorm_distance(T, m, i, MPI[i]) - _znorm_distance(T, m, i, MPI_exp[i])
        assert abs(gap) <= DIST_TOL[dtype], f"MPI[{i}] not an equidistant tie"


def _tie_heavy(n: int, repeats: int, seed: int) -> np.ndarray:
    """``repeats`` exact copies of one motif under 1e-3 noise: every window
    inside it has repeats - 1 near-equal neighbors (more than the 8
    capture slots and the 64 of pass C)."""
    rng = np.random.default_rng(seed)
    L = n // repeats
    motif = np.cumsum(rng.standard_normal(L))
    T = rng.standard_normal(L * repeats) * 1e-3
    for r in range(repeats):
        T[r * L : (r + 1) * L] += motif
    return T


@pytest.mark.cuda
@pytest.mark.parametrize("series", ["random_walk", "tie_heavy"])
def test_hybrid_on_card_matches_cpu(card, series):
    """The hybrid's passes B and C and its float64 rescoring on the card,
    held to the same code on the CPU: distances within 1e-8, indices equal
    or equidistant.  Pass A is K1, one launch a job, no plain sweep."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.utils.profile import BenchmarkProfile

    n, m, band, chunk = 16384, 64, 1024, 4096
    T = _series(n, 5, constant_run=False) if series == "random_walk" else _tie_heavy(n, 80, 5)
    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        prof = BenchmarkProfile()
        cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=band,
                                  chunk=chunk, device=dev)
        calls, launches = mxu.CALLS, mxu_fused.LAUNCHES
        MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
        assert MP.device.type == dev and MP.dtype == torch.float64
        out[dev] = (MP.cpu().numpy(), MPI.cpu().numpy())
        counts[dev] = dict(prof.counts, k1=mxu_fused.LAUNCHES - launches,
                           plain=mxu.CALLS - calls)
    jobs = len(make_job_grid(n - m + 1, band, chunk).r0)
    assert counts["cuda"]["k1"] == jobs and counts["cuda"]["plain"] == 0
    if series == "tie_heavy":
        assert counts["cuda"]["pass_c_rows"] > 0 and counts["cuda"]["row_scan_rows"] > 0
    (MP, MPI), (MPc, MPIc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(MP, MPc, rtol=0, atol=DIST_TOL["float64"])
    for i in np.nonzero(MPI != MPIc)[0]:
        gap = _znorm_distance(T, m, i, MPI[i]) - _znorm_distance(T, m, i, MPIc[i])
        assert abs(gap) <= DIST_TOL["float64"], f"MPI[{i}] not an equidistant tie"
    print(f"\nhybrid {series}: card {counts['cuda']}, cpu {counts['cpu']}, "
          f"max |card - cpu| {np.abs(MP - MPc).max():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [True, False])
def test_tf32_setting_is_left_as_found(card, tf32):
    """The port clears TF32 only around its own float32 products: after
    ``auto``, ``mxu``, ``hybrid`` and the left/right hybrid on the card the
    caller's setting is what it was."""
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    T = _series(3000, 11, constant_run=False)
    try:
        flag.allow_tf32 = tf32
        for kernel, dtype, left_right in (("auto", "float32", False), ("mxu", "float32", False),
                                          ("hybrid", "float64", False),
                                          ("hybrid", "float64", True)):
            cfg = MatrixProfileConfig(m=32, dtype=dtype, kernel=kernel, band=256, chunk=512,
                                      device="cuda")
            compute_matrix_profile(T, config=cfg, left_right=left_right)
            torch.cuda.synchronize()
            assert flag.allow_tf32 is tf32, (kernel, left_right)
    finally:
        flag.allow_tf32 = saved


@pytest.mark.cuda
def test_left_right_hybrid_on_card_matches_cpu(card):
    """The left/right hybrid on the card against the same code on the CPU:
    each side within 1e-8, indices equal or equidistant; pass A is K1, one
    launch a job, no plain sweep."""
    from mpx_torch.config import make_job_grid

    n, m, band, chunk = 16384, 64, 1024, 4096
    T = _series(n, 5, constant_run=True)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=band,
                                  chunk=chunk, device=dev)
        calls, launches = mxu.CALLS, mxu_fused.LAUNCHES
        res = compute_matrix_profile(T, config=cfg, left_right=True)
        assert all(o.device.type == dev for o in res)
        if dev == "cuda":
            assert mxu_fused.LAUNCHES - launches == len(make_job_grid(n - m + 1, band,
                                                                      chunk).r0)
            assert mxu.CALLS == calls
        out[dev] = [o.cpu().numpy() for o in res]
    for side in (0, 2):
        MP, MPI = out["cuda"][side : side + 2]
        MPc, MPIc = out["cpu"][side : side + 2]
        np.testing.assert_allclose(MP, MPc, rtol=0, atol=DIST_TOL["float64"])
        for i in np.nonzero(MPI != MPIc)[0]:
            assert MPI[i] >= 0 and MPIc[i] >= 0, f"side {side} row {i}"
            gap = _znorm_distance(T, m, i, MPI[i]) - _znorm_distance(T, m, i, MPIc[i])
            assert abs(gap) <= DIST_TOL["float64"], f"MPI[{i}] not an equidistant tie"


def _ab_series():
    """Two series with a constant run each (zero-variance windows on both
    axes), lengths off the block tile."""
    A, B = _series(2500, 21, constant_run=False), _series(1900, 22, constant_run=False)
    A[800:900] = A[800]
    B[1200:1290] = -3.0
    return A, B


def _assert_ab_band_close(ours, ref, Ua, Ub, r0, c0, tol):
    for side, base, own_w, cand_w in (("row", r0, Ua, Ub), ("col", c0, Ub, Ua)):
        a, b = getattr(ours, side), getattr(ref, side)
        assert a.value.shape == b.value.shape, (r0, c0, side)
        err = (a.value.double() - b.value.double()).abs().max().item()
        assert err <= tol, (r0, c0, side, err)
        bad = torch.nonzero(a.index != b.index).flatten()
        assert bool(((a.index[bad] >= 0) & (b.index[bad] >= 0)).all())
        own = own_w[base + bad]
        gap = ((own * cand_w[a.index[bad].long()]).sum(1)
               - (own * cand_w[b.index[bad].long()]).sum(1)).abs()
        assert bool((gap <= tol).all()), (r0, c0, side)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [37, 64])
def test_k1_with_column_operand_matches_plain_on_card(card, dtype, m):
    """K1 with a second series as its column operand (``stats_c``) against
    the plain sweep: every job of the AB grid, ragged edges on both axes,
    zero-variance windows in both series, rows off 16-byte boundaries at
    m = 37; one launch a job."""
    from mpx_torch.abjoin import ab_jobs
    from mpx_torch.kernels.common import NO_EXCL

    A, B = _ab_series()
    band, chunk = 200, 328
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    sa, sb = (precompute_statistics(X, m, band=band, chunk=chunk, dtype=dtype, device=card)
              for X in (A, B))
    assert not np.isfinite(sa.inv.cpu().numpy()[:wa]).all()
    assert not np.isfinite(sb.inv.cpu().numpy()[:wb]).all()
    Ua, Ub = sa.windows.double(), sb.windows.double()
    geom = band_geometry(band, chunk, m, wa, wc=wb, excl=NO_EXCL)
    r0s, c0s = ab_jobs(wa, wb, band, chunk)
    launches = mxu_fused.LAUNCHES
    for r0, c0 in zip(r0s.tolist(), c0s.tolist()):
        ours = mxu_fused.sweep_band_mxu_fused(sa, r0, c0 - r0, geom, dtype, stats_c=sb)
        ref = mxu.sweep_band_mxu(sa, r0, c0 - r0, geom, dtype, stats_c=sb)
        torch.cuda.synchronize()
        _assert_ab_band_close(ours, ref, Ua, Ub, r0, c0, BAND_TOL[dtype])
    assert mxu_fused.LAUNCHES == launches + len(r0s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_self_join_is_bit_equal_with_stats_c(card, dtype):
    """The self-join passes one window matrix as both operands: with
    ``stats_c=stats`` K1 gives what it gives without, bit for bit."""
    stats = precompute_statistics(_series(N, 7), M, band=S, chunk=W, dtype=dtype,
                                  device=card)
    geom = band_geometry(S, W, M, W_PROFILE)
    for r0, k0 in EDGE_JOBS:
        one = mxu_fused.sweep_band_mxu_fused(stats, r0, k0, geom, dtype)
        two = mxu_fused.sweep_band_mxu_fused(stats, r0, k0, geom, dtype, stats_c=stats)
        for side in ("row", "col"):
            assert torch.equal(getattr(one, side).value, getattr(two, side).value)
            assert torch.equal(getattr(one, side).index, getattr(two, side).index)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_no_exclusion_bound(card, dtype):
    """The AB-join's NO_EXCL reaches the kernel as -pw (int32 for every pw
    the wrapper accepts, 2**31 - 1 included) and masks exactly what
    ``excl = -pw`` and the plain sweep mask."""
    from mpx_torch.kernels.common import NO_EXCL
    from mpx_torch.kernels.mxu_fused import kernel_excl

    assert kernel_excl(NO_EXCL, 2**31 - 1) == -(2**31 - 1)
    assert kernel_excl(NO_EXCL, 2**30 + 1) == -(2**30 + 1)
    A, B = _ab_series()
    m, band, chunk = 64, 256, 512
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    sa, sb = (precompute_statistics(X, m, band=band, chunk=chunk, dtype=dtype, device=card)
              for X in (A, B))
    pw = sa.windows.shape[0]
    outs = [mxu_fused.sweep_band_mxu_fused(sa, 1024, -1024, band_geometry(
        band, chunk, m, wa, wc=wb, excl=excl), dtype, stats_c=sb) for excl in (NO_EXCL, -pw)]
    ref = mxu.sweep_band_mxu(sa, 1024, -1024, band_geometry(band, chunk, m, wa, wc=wb,
                                                            excl=NO_EXCL), dtype, stats_c=sb)
    for side in ("row", "col"):
        assert torch.equal(getattr(outs[0], side).value, getattr(outs[1], side).value)
        assert torch.equal(getattr(outs[0], side).index, getattr(outs[1], side).index)
    _assert_ab_band_close(outs[0], ref, sa.windows.double(), sb.windows.double(), 1024, 0,
                          BAND_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [("auto", "float32"), ("auto", "float64"),
                                          ("hybrid", "float64")])
def test_ab_join_on_card_matches_cpu(card, kernel, dtype):
    """The AB-join on the card (K1, or the hybrid with K1 as pass A)
    against the same code on the CPU: distances within the profile
    tolerance, indices equal or equidistant; one K1 launch a job.  The two
    constant runs give both series identical step windows (distance 0),
    where sqrt(2m(1 - P)) turns float32's 1e-6 on P into 5e-3: float32 is
    held in correlation there, 1e-5 (K1's band tolerance)."""
    from mpx_torch.abjoin import ab_jobs, compute_ab_join

    A, B = _ab_series()
    m, band, chunk = 64, 512, 1024
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                                  device=dev)
        launches, calls = mxu_fused.LAUNCHES, mxu.CALLS
        res = compute_ab_join(A, B, config=cfg)
        if dev == "cuda":
            jobs = len(ab_jobs(A.shape[0] - m + 1, B.shape[0] - m + 1, band, chunk)[0])
            assert mxu_fused.LAUNCHES - launches == jobs and mxu.CALLS == calls
        out[dev] = [o.cpu().numpy() for o in res]
    tol = DIST_TOL[dtype]
    for (MP, MPI, MPc, MPIc), (Q, R) in (((*out["cuda"][:2], *out["cpu"][:2]), (A, B)),
                                         ((*out["cuda"][2:], *out["cpu"][2:]), (B, A))):
        live = MPIc >= 0
        np.testing.assert_array_equal(MPI >= 0, live)
        if dtype == "float32":
            P, Pc = (1 - np.asarray(d[live], np.float64) ** 2 / (2 * m) for d in (MP, MPc))
            np.testing.assert_allclose(P, Pc, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(MP[live], MPc[live], rtol=0, atol=tol)
        for i in np.nonzero(MPI != MPIc)[0]:
            q = Q[i : i + m]
            d = [_ab_distance(q, R[j : j + m]) for j in (MPI[i], MPIc[i])]
            assert abs(d[0] - d[1]) <= max(tol, 1e-7), (i, MPI[i], MPIc[i])


def _ab_distance(a, b) -> float:
    a, b = (a - a.mean()) / a.std(), (b - b.mean()) / b.std()
    return float(np.sqrt(np.sum((a - b) ** 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topk_tie_order_on_card_matches_cpu(card, dtype):
    """A series of exact copies of one integer segment: every k-list is a
    run of ties, and the card must order them as the CPU does (lax.top_k's
    order, restored by ``_topk_desc``): indices equal."""
    from mpx_torch.topk import compute_topk_profile

    motif = np.random.default_rng(3).integers(-8, 9, 40).astype(np.float64)
    T = np.tile(motif, 60)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = MatrixProfileConfig(m=16, dtype=dtype, band=256, chunk=512, device=dev)
        out[dev] = [o.cpu().numpy() for o in compute_topk_profile(T, k=6, config=cfg)]
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    P = [1 - np.asarray(o[0], np.float64) ** 2 / 32 for o in (out["cuda"], out["cpu"])]
    np.testing.assert_allclose(P[0], P[1], rtol=0, atol=1e-6 if dtype == "float32" else 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thresh_on_card_matches_cpu(card, dtype):
    from mpx_torch.thresh import compute_sum_thresh, compute_sum_thresh_ab

    A, B = _ab_series()
    for fn, args in ((compute_sum_thresh, (A,)), (compute_sum_thresh_ab, (A, B))):
        out = {}
        for dev in ("cuda", "cpu"):
            cfg = MatrixProfileConfig(m=32, dtype=dtype, band=256, chunk=512, device=dev)
            out[dev] = [o.cpu().numpy() for o in fn(*args, config=cfg, threshold=0.4)]
        (s, c), (sc, cc) = out["cuda"], out["cpu"]
        if dtype == "float64":
            np.testing.assert_array_equal(c, cc)
        else:  # float32 products in other orders: a pair at the threshold may flip
            assert np.abs(c.astype(np.int64) - cc).max() <= 2
        np.testing.assert_allclose(s, sc, rtol=1e-4, atol=1.0 if dtype == "float32" else 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [True, False])
def test_tf32_setting_is_left_as_found_by_the_epilogues(card, tf32):
    """After the AB-join (K1 and the hybrid), the top-k and the
    sum-threshold profiles on the card the caller's TF32 setting is what
    it was."""
    from mpx_torch.abjoin import compute_ab_join
    from mpx_torch.thresh import compute_sum_thresh, compute_sum_thresh_ab
    from mpx_torch.topk import compute_topk_ab, compute_topk_profile

    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    A, B = _ab_series()

    def cfg(dtype="float32", kernel="auto"):
        return MatrixProfileConfig(m=32, dtype=dtype, kernel=kernel, band=256, chunk=512,
                                   device="cuda")
    calls = [lambda: compute_ab_join(A, B, config=cfg()),
             lambda: compute_ab_join(A, B, config=cfg("float64", "hybrid")),
             lambda: compute_topk_profile(A, k=3, config=cfg()),
             lambda: compute_topk_ab(A, B, k=3, config=cfg()),
             lambda: compute_sum_thresh(A, config=cfg(), threshold=0.5),
             lambda: compute_sum_thresh_ab(A, B, config=cfg(), threshold=0.5)]
    try:
        flag.allow_tf32 = tf32
        for i, call in enumerate(calls):
            call()
            torch.cuda.synchronize()
            assert flag.allow_tf32 is tf32, i
    finally:
        flag.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 8])
def test_topk_hybrid_on_card_matches_strict_tile(card, k):
    """The float64 top-k hybrid on the card (pass A through K1, one launch
    a job) on a tie-heavy series, against the strict float64 tile on the
    card: distances within 1e-10, an index differing only between
    neighbors equidistant within 1e-8; pass C resolves rows."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.topk import compute_topk_profile
    from mpx_torch.utils.profile import BenchmarkProfile

    n, m, band, chunk = 8192, 64, 1024, 4096
    T = _tie_heavy(n, 60, 9)
    prof = BenchmarkProfile()
    launches = mxu_fused.LAUNCHES
    D, I = (o.cpu().numpy() for o in compute_topk_profile(T, k=k, config=MatrixProfileConfig(
        m=m, dtype="float64", kernel="hybrid", band=band, chunk=chunk, device="cuda"),
        profile=prof))
    assert mxu_fused.LAUNCHES - launches == len(make_job_grid(T.shape[0] - m + 1, band,
                                                              chunk).r0)
    assert sum(prof.counts["resolved_pass_c"]) + sum(prof.counts["resolved_narrow"]) > 0
    Ds, Is = (o.cpu().numpy() for o in compute_topk_profile(T, k=k, config=MatrixProfileConfig(
        m=m, dtype="float64", band=band, chunk=chunk, device="cuda")))
    np.testing.assert_allclose(D, Ds, rtol=0, atol=1e-10)
    for r, j in zip(*np.nonzero(I != Is)):
        gap = _znorm_distance(T, m, r, I[r, j]) - _znorm_distance(T, m, r, Is[r, j])
        assert abs(gap) <= DIST_TOL["float64"], (r, j)
    print(f"\ntop-k hybrid k={k}: {dict(prof.counts)}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_aamp_on_card_matches_cpu(card, dtype):
    """The raw-Euclidean self-join and AB-join on the card against the same
    code on the CPU: distances within mpx's tolerance of the largest (2e-4
    float32, 1e-10 float64), indices equal or equidistant."""
    from mpx_torch.aamp import compute_aamp_ab_join, compute_aamp_profile

    A, B = _ab_series()
    tol = {"float32": 2e-4, "float64": 1e-10}[dtype]
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = MatrixProfileConfig(m=32, dtype=dtype, band=256, chunk=512, device=dev)
        runs[dev] = [o.cpu().numpy() for o in (*compute_aamp_profile(A, config=cfg),
                                               *compute_aamp_ab_join(A, B, config=cfg))]
    for (D, I), (Dc, Ic), X, Y in zip(zip(runs["cuda"][::2], runs["cuda"][1::2]),
                                      zip(runs["cpu"][::2], runs["cpu"][1::2]),
                                      (A, A, B), (A, B, A)):
        np.testing.assert_allclose(D, Dc, rtol=0, atol=tol * Dc.max())
        for i in np.nonzero(I != Ic)[0]:
            a = X[i : i + 32]
            gap = (np.linalg.norm(a - Y[I[i] : I[i] + 32])
                   - np.linalg.norm(a - Y[Ic[i] : Ic[i] + 32]))
            assert abs(gap) <= tol * Dc.max(), i


@pytest.mark.cuda
@pytest.mark.parametrize("with_b", [False, True])
def test_pooled_matrix_on_card_matches_cpu(card, with_b):
    """The pooled summary on the card against the same code on the CPU,
    within 2e-3 (float32 tiles): the self-join (tiles merged transposed)
    and the AB-join."""
    from mpx_torch.distmatrix import pooled_matrix

    A, B = _ab_series()
    out = {dev: pooled_matrix(A, 32, mwidth=13, mheight=11, B=B if with_b else None,
                              config=MatrixProfileConfig(m=32, band=256, chunk=256,
                                                         device=dev))
           for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("float64", 1e-10)])
@pytest.mark.parametrize("kwargs", [dict(), dict(include=[1]), dict(discords=True)])
def test_mstamp_on_card_matches_cpu(card, dtype, tol, kwargs):
    """The multi-dimensional profile on the card (torch.bmm tiles, sort,
    prefix means) against the same code on the CPU, with a flat segment
    in one dimension: distances within tol, indices equal or
    equidistant."""
    from mpx_torch.mstamp import compute_multidim_profile

    T = np.stack([_series(2048, 60 + t, constant_run=t == 1) for t in range(3)])
    out = {dev: compute_multidim_profile(T, config=MatrixProfileConfig(
        m=64, dtype=dtype, band=256, chunk=512, device=dev), **kwargs)
        for dev in ("cuda", "cpu")}
    got, exp = out["cuda"], out["cpu"]
    fin = np.isfinite(exp.PMP)
    np.testing.assert_array_equal(np.isfinite(got.PMP), fin)
    np.testing.assert_allclose(got.PMP[fin], exp.PMP[fin], rtol=0, atol=tol)
    k, i = np.nonzero(got.PMPI != exp.PMPI)
    np.testing.assert_allclose(got.PMP[k, i], exp.PMP[k, i], rtol=0, atol=tol)


@pytest.mark.cuda
def test_fused_pan_on_card_matches_exact_pan_on_card(card):
    """The fused float32 pan surface on the card within 2e-3 of the exact
    float64 surface on the card (K1 per length, K3 above m = 4096 is not
    reached here); indices equal or equidistant."""
    from mpx_torch.pan import compute_pan_profile

    T = _series(4096, 70, constant_run=False)
    ms = [32, 48, 64, 100, 128, 256]
    cfg = dict(band=512, chunk=1024, device="cuda")
    fused = compute_pan_profile(T, ms, config=MatrixProfileConfig(m=32, **cfg), method="fused")
    exact = compute_pan_profile(T, ms, config=MatrixProfileConfig(m=32, dtype="float64", **cfg))
    for r, m in enumerate(ms):
        w = T.shape[0] - m + 1
        np.testing.assert_allclose(fused.PMP[r, :w], exact.PMP[r, :w], rtol=0, atol=2e-3)
        for i in np.nonzero(fused.PMPI[r, :w] != exact.PMPI[r, :w])[0]:
            gap = (_znorm_distance(T, m, i, fused.PMPI[r, i])
                   - _znorm_distance(T, m, i, exact.PMPI[r, i]))
            assert abs(gap) <= 2e-3, (m, i)


@pytest.mark.cuda
def test_multi_length_discords_on_card_match_the_brute_force(card):
    """MERLIN on the card (the fused survey, the float64 row scans on the
    card) against the numpy brute force at n = 2048, within 1e-9."""
    from mpx_torch.merlin import brute_force_multi_length_discords, multi_length_discords

    T = _series(2048, 71, constant_run=False)
    T[1200:1232] += np.linspace(0, 12, 32)
    ms = [24, 32, 40]
    res = multi_length_discords(T, ms=ms, config=MatrixProfileConfig(m=24, device="cuda"))
    exp = brute_force_multi_length_discords(T, ms)
    assert res.exact and [d.m for d in res.per_length] == ms
    for got, want in zip(res.per_length, exp):
        assert abs(got.distance - want.distance) <= 1e-9, (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mode", [("float64", "full"), ("float32", "full"),
                                        ("float64", "right"), ("float64", "left")])
def test_streaming_on_card_matches_cpu(card, dtype, mode):
    """The streaming state on the card (bootstrap through K1, appends as
    torch ops) against the port's CPU run of the same appends, across a
    capacity doubling and (right) a trim; 2e-3 / 1e-8, indices equal or
    equidistant."""
    from mpx_torch.streaming import StreamingMatrixProfile

    T = _series(4096, 72, constant_run=False)
    m = 32
    runs = [StreamingMatrixProfile(T[:1000], m, dtype, mode, device=dev)
            for dev in ("cuda", "cpu")]
    for s in range(1000, 4096, 300):
        for smp in runs:
            smp.append(T[s : s + 300])
            if mode == "right" and smp.series.shape[0] > 3000:
                smp.trim_head(1000)
    assert runs[0].capacity_doublings == runs[1].capacity_doublings >= 1
    (MP, MPI), (MPc, MPIc) = (smp.profile() for smp in runs)
    kept = T[runs[0].offset :]
    np.testing.assert_array_equal(MPI < 0, MPIc < 0)
    fin = MPI >= 0
    np.testing.assert_allclose(MP[fin], MPc[fin], rtol=0, atol=DIST_TOL[dtype])
    for i in np.nonzero(MPI != MPIc)[0]:
        gap = _znorm_distance(kept, m, i, MPI[i]) - _znorm_distance(kept, m, i, MPIc[i])
        assert abs(gap) <= DIST_TOL[dtype], (i, MPI[i], MPIc[i])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["auto", "hybrid"])
def test_checkpoint_resume_on_card_is_bit_equal(card, tmp_path, monkeypatch, kernel):
    """A checkpointed run on the card (K1, or the hybrid with K1's pass A)
    killed after its second save and resumed equals an uninterrupted run
    bit for bit."""
    from mpx_torch import checkpoint, hybrid
    from mpx_torch.checkpoint import compute_with_checkpoint

    class Killed(RuntimeError):
        pass

    T = _series(8192, 73)
    cfg = MatrixProfileConfig(m=64, dtype="float64", kernel=kernel, band=512, chunk=1024,
                              device="cuda")
    path = str(tmp_path / "ck.npz")
    monkeypatch.setattr(hybrid, "CKPT_JOBS", 8)
    MP0, MPI0 = compute_with_checkpoint(T, cfg, path, group_jobs=8)
    saves = []
    real_save, real_save_npz = checkpoint._save, checkpoint._save_npz

    def dying(real):
        def save(*args, **kwargs):
            real(*args, **kwargs)
            saves.append(1)
            if len(saves) == 2:
                raise Killed
        return save

    monkeypatch.setattr(checkpoint, "_save", dying(real_save))
    monkeypatch.setattr(checkpoint, "_save_npz", dying(real_save_npz))
    with pytest.raises(Killed):
        compute_with_checkpoint(T, cfg, path, group_jobs=8)
    monkeypatch.setattr(checkpoint, "_save", real_save)
    monkeypatch.setattr(checkpoint, "_save_npz", real_save_npz)
    MP1, MPI1 = compute_with_checkpoint(T, cfg, path, group_jobs=8)
    np.testing.assert_array_equal(MP0, MP1)
    np.testing.assert_array_equal(MPI0, MPI1)
    MPd, MPId = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
    np.testing.assert_allclose(MP1, MPd, rtol=0, atol=DIST_TOL["float64"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fleet_on_card_equals_single_runs(card, dtype):
    """``compute_batch_profiles`` on the card: each row bit for bit the
    single-series profile on the card, and within tolerance of the CPU."""
    from mpx_torch.batch import compute_batch_profiles

    batch = np.stack([_series(1024, 80 + b, constant_run=b == 1) for b in range(6)])
    cfg = MatrixProfileConfig(m=32, dtype=dtype, band=256, chunk=256, device="cuda")
    MP, MPI = compute_batch_profiles(batch, config=cfg, group=4)
    cpu = compute_batch_profiles(batch, config=MatrixProfileConfig(
        m=32, dtype=dtype, band=256, chunk=256, device="cpu"))
    for b in range(6):
        one = [o.cpu().numpy() for o in compute_matrix_profile(batch[b], config=cfg)]
        np.testing.assert_array_equal(MP[b], one[0])
        np.testing.assert_array_equal(MPI[b], one[1])
        np.testing.assert_allclose(MP[b], cpu[0][b], rtol=0, atol=DIST_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8])
def test_k3_f64_holds_1e8_on_offset_walks(card, seed):
    """K3 in float64 (``kernel='pallas'``) on a walk whose level (1e5) is
    large beside its spread: within 1e-8 of the explicit distance matrix,
    with the recurrence tier's corrected window means."""
    from mpx_torch.reference import brute_force_matrix_profile

    T = np.cumsum(np.random.default_rng(seed).standard_normal(4096)) + 1e5
    cfg = MatrixProfileConfig(m=64, dtype="float64", kernel="pallas", band=512, chunk=1024,
                              device="cuda")
    before = recurrence.LAUNCHES
    MP, _ = compute_matrix_profile(T, config=cfg)
    assert recurrence.LAUNCHES > before
    exp, _ = brute_force_matrix_profile(T, 64)
    err = float(np.abs(MP.cpu().numpy() - exp).max())
    print(f"K3 f64 offset walk seed {seed}: max err {err:.3e}")
    assert err <= DIST_TOL["float64"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_contrast_on_card_matches_cpu(card, dtype):
    """The contrast profile's two joins through K1 on the card, against
    the same composition on the CPU."""
    from mpx_torch.contrast import contrast_profile

    plus, minus = _series(3000, 91, constant_run=False), _series(2500, 92)
    kw = dict(m=64, dtype=dtype, band=512, chunk=1024)
    before = mxu_fused.LAUNCHES
    got = contrast_profile(plus, minus, config=MatrixProfileConfig(device="cuda", **kw))
    assert mxu_fused.LAUNCHES > before
    exp = contrast_profile(plus, minus, config=MatrixProfileConfig(device="cpu", **kw))
    for name in ("cp", "mp_aa", "mp_ab"):
        np.testing.assert_allclose(getattr(got, name), getattr(exp, name), rtol=0,
                                   atol=DIST_TOL[dtype], err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chains_on_card_match_cpu(card, dtype):
    """``compute_chains`` on the card: in float64 the same left/right
    indices and chain as on the CPU; in either dtype the chain of the
    card's own left/right profile."""
    from mpx_torch.chains import anchored_chain, compute_chains

    T = _series(3000, 93, constant_run=False)
    kw = dict(m=32, dtype=dtype, band=512, chunk=1024)
    got = compute_chains(T, MatrixProfileConfig(device="cuda", **kw))
    out = compute_matrix_profile(T, config=MatrixProfileConfig(device="cuda", **kw),
                                 left_right=True)
    np.testing.assert_array_equal(got.mpi_left, out[1].cpu().numpy())
    np.testing.assert_array_equal(got.mpi_right, out[3].cpu().numpy())
    np.testing.assert_array_equal(got.chain, anchored_chain(
        got.mpi_left, got.mpi_right, int(got.lengths.argmax())))
    if dtype == "float64":
        exp = compute_chains(T, MatrixProfileConfig(device="cpu", **kw))
        np.testing.assert_array_equal(got.mpi_left, exp.mpi_left)
        np.testing.assert_array_equal(got.mpi_right, exp.mpi_right)
        np.testing.assert_array_equal(got.chain, exp.chain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1024, 2048])
def test_k1_f32_holds_2e3_at_large_m(card, m):
    """K1's float32 sweep at large m (its per-slab promoted accumulation)
    within 2e-3 of the exact f64 distances on a walk with noisy planted
    copies (one job of 512 rows against every window)."""
    from mpx_torch.hybrid import _row_scan
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused

    rng = np.random.default_rng(m)
    n, S, Wj = 8192 + m - 1, 512, 8192
    T = np.cumsum(rng.standard_normal(n))
    src = [17, 211, 333][: (n - 4096 - m) // m]
    for k, s in enumerate(src):
        seg = T[s : s + m]
        at = 4096 + k * m
        T[at : at + m] = seg - seg[0] + T[at] + 0.05 * seg.std() * rng.standard_normal(m)
    w = n - m + 1
    stats = precompute_statistics(T, m, band=S, chunk=Wj, dtype="float32", device=card)
    ex = precompute_statistics(T, m, band=S, chunk=Wj, dtype="float64", device=card,
                               windows=False)
    rows = np.union1d(src, np.arange(0, S - m // 4, 7))
    bestP, _ = _row_scan(ex.T, ex.mu[:w], ex.inv[:w], m, w, m // 4, rows, side=+1)
    exact = torch.sqrt(torch.clamp(2.0 * m * (1.0 - bestP), min=0.0)).cpu().numpy()
    P = sweep_band_mxu_fused(stats, 0, 0, band_geometry(S, Wj, m, w), "float32").row.value
    got = torch.sqrt(torch.clamp(2.0 * m * (1.0 - P.double()), min=0.0)).cpu().numpy()
    err = np.abs(got[rows] - exact).max()
    assert err <= DIST_TOL["float32"], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [("float32", "auto"), ("float64", "pallas")])
def test_four_virtual_shards_equal_one_device(card, dtype, kernel):
    """Job sharding over four virtual shards of one card (K1 or K3 on each):
    values bit-equal to the single-device run, indices equal or tied."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.ops.aggregates import postcompute
    from mpx_torch.ops.precompute import precompute_statistics as stage
    from mpx_torch.parallel.sharding import run_jobs_sharded

    T = _series(8192, seed=45)
    m, S, Wc = 64, 512, 2048
    w = T.shape[0] - m + 1
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=S, chunk=Wc, device="cuda")
    MP1, MPI1 = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
    stats = stage(T, m, band=S, chunk=Wc, dtype=dtype, device=card, windows=kernel == "auto",
                  exact_mean=kernel == "pallas")
    launches = (mxu_fused.LAUNCHES, recurrence.LAUNCHES)
    rows, cols = run_jobs_sharded(stats, make_job_grid(w, S, Wc), num_shards=4, S=S, W=Wc,
                                  m=m, w=w, kernel="mxu_fused" if kernel == "auto" else kernel,
                                  dtype=dtype, mesh=(card,) * 4)
    MP4, MPI4 = (o.cpu().numpy() for o in postcompute(rows, cols, m, w))
    assert (mxu_fused.LAUNCHES, recurrence.LAUNCHES) != launches
    np.testing.assert_array_equal(MP1, MP4)
    for i in np.nonzero(MPI1 != MPI4)[0]:
        assert abs(_znorm_distance(T, m, i, MPI1[i]) - _znorm_distance(T, m, i, MPI4[i])) \
            <= DIST_TOL[dtype]
