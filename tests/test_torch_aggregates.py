"""mpx_torch.ops.aggregates against mpx.ops.aggregates.

The merges are comparisons and selections, so values and indices must
agree exactly; the distance conversion runs the same float formula, so
distances agree within 1e-12 (float64) and 1e-6 (float32), absolute and
relative (the untouched sentinel distance is ~1e7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpx.dtypes import x64_scope
from mpx.ops import aggregates as J
from mpx.types import Aggregates as JAgg
from mpx_torch.ops import aggregates as P
from mpx_torch.types import Aggregates as PAgg

DIST_TOL = {"float64": 1e-12, "float32": 1e-6}


def _pair(rng, n, dtype, tie_with=None):
    """(value, index) numpy arrays; with ``tie_with`` half the values are
    copied from it so the merge sees exact ties."""
    v = rng.uniform(-1, 1, n).astype(dtype)
    v[rng.random(n) < 0.2] = -1e12  # untouched aggregates
    if tie_with is not None:
        tie = rng.random(n) < 0.5
        v[tie] = tie_with[tie]
    i = rng.integers(-1, 10 * n, n).astype(np.int32)
    return v, i


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_merge_aggregates_ties_keep_incumbent(dtype):
    rng = np.random.default_rng(1)
    av, ai = _pair(rng, 500, dtype)
    bv, bi = _pair(rng, 500, dtype, tie_with=av)
    ours = P.merge_aggregates(PAgg(torch.from_numpy(av), torch.from_numpy(ai)),
                              PAgg(torch.from_numpy(bv), torch.from_numpy(bi)))
    with x64_scope(dtype == "float64"):
        ref = J.merge_aggregates(JAgg(jnp.asarray(av), jnp.asarray(ai)),
                                 JAgg(jnp.asarray(bv), jnp.asarray(bi)))
        ref = (np.asarray(ref.value), np.asarray(ref.index))
    np.testing.assert_array_equal(_np(ours.value), ref[0])
    np.testing.assert_array_equal(_np(ours.index), ref[1])
    tie = av == bv
    assert tie.sum() > 100
    np.testing.assert_array_equal(_np(ours.index)[tie], ai[tie])


@pytest.mark.parametrize("offset", [0, 17, 100])
def test_merge_window_in_place(offset):
    rng = np.random.default_rng(offset)
    gv, gi = _pair(rng, 160, "float64")
    wv, wi = _pair(rng, 60, "float64", tie_with=gv[offset : offset + 60])
    glob = PAgg(torch.from_numpy(gv.copy()), torch.from_numpy(gi.copy()))
    value_storage = glob.value.data_ptr()
    P.merge_window(glob, PAgg(torch.from_numpy(wv), torch.from_numpy(wi)), offset)
    assert glob.value.data_ptr() == value_storage  # updated in place
    with x64_scope():
        ref = J.merge_window(JAgg(jnp.asarray(gv), jnp.asarray(gi)),
                             JAgg(jnp.asarray(wv), jnp.asarray(wi)), offset)
        ref = (np.asarray(ref.value), np.asarray(ref.index))
    np.testing.assert_array_equal(glob.value.numpy(), ref[0])
    np.testing.assert_array_equal(glob.index.numpy(), ref[1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("left_right", [False, True])
def test_postcompute(dtype, left_right):
    rng = np.random.default_rng(3)
    m, w, L = 32, 300, 420
    rv, ri = _pair(rng, L, dtype)
    cv, ci = _pair(rng, L, dtype, tie_with=rv)
    rv[5] = np.asarray(1 + 1e-7, dtype)  # rounding past 1: distance clamps to 0
    ours_fn = P.postcompute_left_right if left_right else P.postcompute
    ref_fn = J.postcompute_left_right if left_right else J.postcompute
    ours = ours_fn(PAgg(torch.from_numpy(rv), torch.from_numpy(ri)),
                   PAgg(torch.from_numpy(cv), torch.from_numpy(ci)), m, w)
    with x64_scope(dtype == "float64"):
        ref = ref_fn(JAgg(jnp.asarray(rv), jnp.asarray(ri)),
                     JAgg(jnp.asarray(cv), jnp.asarray(ci)), m, w)
        ref = [np.asarray(x) for x in ref]
    assert len(ours) == len(ref)
    for k, (a, b) in enumerate(zip(ours, ref)):
        a = _np(a)
        assert a.shape == b.shape == (w,)
        if b.dtype == np.int32:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=f"output {k}")
        else:
            assert a.dtype == np.dtype(dtype)
            np.testing.assert_allclose(a, b, rtol=DIST_TOL[dtype],
                                       atol=DIST_TOL[dtype])
    if not left_right:
        assert _np(ours[0])[5] == 0.0


def test_pearson_to_euclidean_clamps():
    P_ = torch.tensor([1.0, 1.0 + 1e-12, 0.5, -1.0, -1e12], dtype=torch.float64)
    d = P.pearson_to_euclidean(P_, 8).numpy()
    np.testing.assert_allclose(d, [0.0, 0.0, np.sqrt(8.0), np.sqrt(32.0),
                                   np.sqrt(16 * (1 + 1e12))], rtol=1e-15)


def test_init_aggregates():
    agg = P.init_aggregates(7, torch.float32, -1e12, "cpu")
    assert agg.value.dtype == torch.float32 and agg.index.dtype == torch.int32
    assert (agg.value == -1e12).all() and (agg.index == -1).all()
