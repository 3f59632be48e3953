"""mpx_torch on an NVIDIA GPU: K1 and K3 against their plain versions,
and the self-join end to end against the numpy golden oracle.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor mpx, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1's band values 1e-5 (float32) / 1e-12 (float64), the two
sides summing m products in different orders; K3's 1e-4 / 1e-12, the
recurrence carrying its rounding down the band's rows in another order
(1e-4 is the bound mpx holds its Pallas kernel to against its XLA sweep);
distances 2e-3 / 1e-8, the repo's profile tolerances.  Indices may differ
only between ties.
"""

import numpy as np
import pytest
import torch

from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.kernels import mxu, mxu_fused, recurrence, xla
from mpx_torch.kernels.common import band_geometry
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.reference import compute_matrix_profile_reference

BAND_TOL = {"float32": 1e-5, "float64": 1e-12}
K3_BAND_TOL = {"float32": 1e-4, "float64": 1e-12}
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k3_matches_plain_on_card(card, dtype):
    stats = precompute_statistics(_series(N, 7), M, band=S, chunk=W, dtype=dtype,
                                  device=card)
    U64 = stats.windows.double()
    geom = band_geometry(S, W, M, W_PROFILE)
    launches = recurrence.LAUNCHES
    for r0, k0 in EDGE_JOBS:
        ours = recurrence.sweep_band_recurrence(stats, r0, k0, geom, dtype)
        ref = xla.sweep_band_xla(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        assert ours.col.value.shape == (S + W,)
        _assert_band_close(ours, ref, U64, r0, k0, K3_BAND_TOL[dtype])
    assert recurrence.LAUNCHES == launches + len(EDGE_JOBS)


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
