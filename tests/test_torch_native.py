"""mpx_torch.native (the port's copy of the host C++ library) against
mpx.native.

Both libraries are built here from byte-identical sources with the same
g++ flags on the same machine, so every entry point is held bit for bit
to mpx's on the same seeded inputs.  A build without a compiler raises,
with no fallback, and the library lands under ``mpx_torch/_build/``.
"""

import os

import numpy as np
import pytest

from mpx import native as mpx_native
from mpx_torch import native
from tests.conftest import random_walk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _series(kind: str) -> np.ndarray:
    if kind == "walk":
        return random_walk(2048, seed=41)
    if kind == "constant-run":
        T = random_walk(2048, seed=42)
        T[700:900] = T[700]
        return T
    t = np.arange(1024.0)
    return 1000 + np.tanh((t - 512) / 80) + 1e-3 * np.sin(t / 11)


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sources_are_identical():
    with open(os.path.join(REPO, "mpx", "native", "scamp_host.cpp"), "rb") as f:
        theirs = f.read()
    with open(os.path.join(REPO, "mpx_torch", "native", "scamp_host.cpp"), "rb") as f:
        assert f.read() == theirs


def test_library_builds_under_build_dir():
    native.load()
    so = native.library_path()
    assert os.path.dirname(so) == os.path.join(REPO, "mpx_torch", "_build")
    assert os.path.exists(so) and native.is_available() and native.build_error() is None


@pytest.mark.parametrize("kind", ["walk", "constant-run", "tanh-step"])
@pytest.mark.parametrize("m", [16, 33, 100])
@pytest.mark.parametrize("entry", ["precompute", "precompute_stats"])
def test_statistics_bit_equal(entry, kind, m):
    T = _series(kind)
    _equal(getattr(native, entry)(T, m), getattr(mpx_native, entry)(T, m))


@pytest.mark.parametrize("n,m", [(512, 16), (1037, 33)])
def test_golden_scamp_bit_equal(n, m):
    T = random_walk(n, seed=n + m)
    _equal(native.golden_scamp(T, m), mpx_native.golden_scamp(T, m))


def _operands(kind: str, m: int):
    T = _series(kind)
    s = mpx_native.precompute(T, m)
    return T, s["mu"], s["inv"], T.shape[0] - m + 1


@pytest.mark.parametrize("kind", ["walk", "constant-run"])
def test_scorers_bit_equal(kind):
    m = 32
    T, mu, inv, w = _operands(kind, m)
    rng = np.random.default_rng(7)
    rows = rng.integers(-1, w, 300).astype(np.int32)
    cols = rng.integers(-1, w, 300).astype(np.int32)
    _equal(native.rescore(T, mu, inv, m, rows, cols),
           mpx_native.rescore(T, mu, inv, m, rows, cols))
    _equal(native.resolve_sym(T, mu, inv, m, rows, cols, w),
           mpx_native.resolve_sym(T, mu, inv, m, rows, cols, w))
    cand = rng.integers(-2, w + 2, (w, 6)).astype(np.int32)
    cand[::3, 1] = cand[::3, 0]  # duplicate slots
    _equal(native.resolve_slots(T, mu, inv, m, cand, w),
           mpx_native.resolve_slots(T, mu, inv, m, cand, w))
    scan = np.array([0, 5, 700, 800, w - 1, -1], np.int32)
    _equal(native.row_scan(T, mu, inv, m, w, m // 4, scan),
           mpx_native.row_scan(T, mu, inv, m, w, m // 4, scan))


def test_ab_scorers_bit_equal():
    m = 24
    Tq, muq, invq, wq = _operands("constant-run", m)
    Tt, mut, invt, wt = _operands("walk", m)
    Tt, mut, invt, wt = Tt[:1500], mut[:1500 - m + 1], invt[:1500 - m + 1], 1500 - m + 1
    ops = (Tq, muq, invq, Tt, mut, invt)
    rng = np.random.default_rng(8)
    rows = rng.integers(-1, wq, 300).astype(np.int32)
    cols = rng.integers(-1, wt, 300).astype(np.int32)
    _equal(native.rescore_ab(*ops, m, rows, cols), mpx_native.rescore_ab(*ops, m, rows, cols))
    cand = rng.integers(-2, wt + 2, (wq, 5)).astype(np.int32)
    cand[::4, 2] = cand[::4, 1]
    _equal(native.resolve_slots_ab(*ops, m, cand, wq, wt),
           mpx_native.resolve_slots_ab(*ops, m, cand, wq, wt))
    scan = np.array([0, 3, 750, wq - 1], np.int32)
    for excl in (-1, m // 4):
        _equal(native.row_scan_ab(*ops, m, wt, excl, scan),
               mpx_native.row_scan_ab(*ops, m, wt, excl, scan))


def test_merge_aggregates_bit_equal():
    rng = np.random.default_rng(9)
    a_val, b_val = rng.standard_normal(1000), rng.standard_normal(1000)
    b_val[::5] = a_val[::5]  # ties keep a
    a_idx, b_idx = (rng.integers(0, 1000, 1000).astype(np.int32) for _ in range(2))
    ours = native.merge_aggregates(a_val.copy(), a_idx.copy(), b_val, b_idx)
    theirs = mpx_native.merge_aggregates(a_val.copy(), a_idx.copy(), b_val, b_idx)
    _equal(ours, theirs)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No compiler: every entry point raises (no numpy fallback), and the
    banner's ``build_error`` names the cause."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    T = random_walk(256, seed=1)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.precompute(T, 16)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.precompute_stats(T, 16)
    assert not native.is_available()
    assert native.build_error().startswith("native build failed: cannot run")
    assert not list(tmp_path.iterdir())


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="native build failed") as e:
        native.load()
    assert "broken.cpp" in str(e.value)
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix == ".so"]
