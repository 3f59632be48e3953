"""The recurrence tier's window means (``exact_mean`` in
``mpx_torch.ops.precompute``).

The float64 recurrence (``kernel="xla"``, and K3 through
``kernel="pallas"``) integrates any error of ``dg`` along a diagonal.  On
a walk whose level is large beside its spread the running mean drifts by
~1e-10 from the exact window mean and the profile missed 1e-8; with the
corrected mean both tiers hold 1e-8 against the explicit distance matrix
(``mpx.reference.brute_force_matrix_profile``, which shares nothing with
the recurrence).  The statistics of the other tiers stay bit for bit
mpx native's.
"""

import math

import numpy as np
import pytest

from mpx import native as mpx_native
from mpx.reference import brute_force_matrix_profile
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch import driver as port_driver
from mpx_torch.ops.precompute import precompute_statistics_numpy


def _offset_walk(seed: int, n: int = 4096) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).standard_normal(n)) + 1e5


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [7, 8])
def test_recurrence_tiers_hold_1e8_on_offset_walks(seed, kernel):
    T = _offset_walk(seed)
    m = 64
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel=kernel, band=512, chunk=1024,
                              device="cpu")
    MP, _ = compute_matrix_profile(T, config=cfg)
    exp, _ = brute_force_matrix_profile(T, m)
    err = float(np.abs(MP.numpy() - exp).max())
    assert err <= 1e-8, err


def test_corrected_mean_is_within_one_ulp_of_the_exact_mean():
    T = _offset_walk(3, n=700)
    m = 48
    s = precompute_statistics_numpy(T, m, exact_mean=True)
    w = T.shape[0] - m + 1
    exact = np.array([math.fsum(T[i : i + m]) / m for i in range(w)])
    err = np.abs(s["mu"] - exact)
    assert (err <= np.spacing(np.abs(exact))).all(), float((err / np.spacing(exact)).max())
    # The same dg identity as the running mean's, from the corrected mean;
    # df does not depend on the mean and inv (the zero-variance
    # classification with it) is unchanged.
    plain = precompute_statistics_numpy(T, m)
    np.testing.assert_array_equal(s["df"], plain["df"])
    np.testing.assert_array_equal(s["inv"], plain["inv"])
    np.testing.assert_array_equal(
        s["dg"][1:], (T[m:] - s["mu"][1:]) + (T[: w - 1] - s["mu"][: w - 1]))


@pytest.mark.parametrize("kernel,exact", [("mxu", False), ("xla", True), ("pallas", True)])
def test_only_the_recurrence_stages_corrected_means(monkeypatch, kernel, exact):
    """The driver stages K1's statistics bit for bit as mpx native computes
    them, and the recurrence's with the corrected mean."""
    T = _offset_walk(9, n=1500)
    m = 32
    seen = []
    real = port_driver.precompute_statistics

    def spy(*args, **kwargs):
        st = real(*args, **kwargs)
        seen.append(st)
        return st

    monkeypatch.setattr(port_driver, "precompute_statistics", spy)
    compute_matrix_profile(T, config=MatrixProfileConfig(
        m=m, dtype="float64", kernel=kernel, band=256, chunk=512, device="cpu"))
    (st,) = seen
    w = T.shape[0] - m + 1
    ref = mpx_native.precompute(T, m)
    mine = precompute_statistics_numpy(T, m, exact_mean=exact)
    for name in ("mu", "df", "dg"):
        np.testing.assert_array_equal(getattr(st, name).numpy()[:w], mine[name])
        if not exact:
            np.testing.assert_array_equal(getattr(st, name).numpy()[:w], ref[name])
    assert exact == (not np.array_equal(st.mu.numpy()[:w], ref["mu"]))
