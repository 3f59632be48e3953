"""The left/right hybrid of mpx_torch (``kernel='hybrid'``,
``left_right=True``, on the CPU) against mpx and the golden oracles, and
the hybrid's width gate on the captures.

On the CPU the port's pass A is the plain float32 sweep; passes B and C
are float32 products and the exact stages float64, as on the card.  Every
call to mpx's hybrid runs with ``MPX_HYBRID_CASCADE=0``, mpx's default.
Tolerances: distances 1e-8 with the equidistant-tie rule
(tests/helpers.py) on each side; thresholds 1e-5 (the two packages'
float32 products sum in other orders); the dense and the sparse pass B,
and a float32 request against the float64 one, exactly.
"""

import os

import numpy as np
import pytest
import torch

import mpx
import mpx.hybrid as mpx_hybrid
from mpx.cli import main as mpx_main
from mpx_torch import MatrixProfileConfig, compute_matrix_profile, hybrid
from mpx_torch.cli import main as port_main
from mpx_torch.config import make_job_grid
from mpx_torch.dtypes import full_precision_matmul
from mpx_torch.io.tsb import read_binary, read_series
from mpx_torch.ops.precompute import precompute_statistics_numpy
from mpx_torch.utils.profile import BenchmarkProfile, counters
from tests.conftest import DATA_DIR, random_walk
from tests.helpers import assert_profile_close
from tests.test_left_right import brute_force_left_right

EPS = 1e-8


@pytest.fixture(autouse=True)
def _mpx_default_pass_a(monkeypatch):
    monkeypatch.setenv("MPX_HYBRID_CASCADE", "0")


def _motifs(repeats: int, seed: int, noise: float = 1e-3) -> np.ndarray:
    """``repeats`` copies of one 24-sample sine period under ``noise``:
    every window has repeats - 1 near-equal neighbors, spread over both
    sides."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal(24 * repeats) * noise
    T += np.tile(np.sin(np.linspace(0, 2 * np.pi, 24)), repeats)
    return T


def _series(name: str):
    """(T, m, band, chunk) of the shapes mpx's own left/right hybrid tests
    use (tests/test_hybrid.py), a constant stretch, and a repeated motif."""
    if name == "random_walk":
        return random_walk(900, seed=81), 24, 64, 128
    if name == "motifs":
        return _motifs(12, 83), 16, 32, 64
    T = random_walk(300, seed=5)
    T[100:180] = 2.5  # zero-variance windows: no neighbor on either side
    return T, 16, 32, 64


def _left_right(T, m, band, chunk, dtype="float64"):
    """The port's left/right hybrid on the CPU: four numpy arrays and the
    profile's counts."""
    prof = BenchmarkProfile()
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel="hybrid", band=band, chunk=chunk,
                              device="cpu")
    out = compute_matrix_profile(T, config=cfg, profile=prof, left_right=True)
    assert all(o.device.type == "cpu" for o in out)
    return [o.numpy() for o in out], prof.counts


def _assert_sides(T, m, ours, ref, eps=EPS):
    for side in (0, 2):  # left, right
        assert_profile_close(T, m, ours[side], ours[side + 1], ref[side], ref[side + 1],
                             eps=eps)


def _brute(T, m):
    """brute_force_left_right with the tiers' sentinels where a side has no
    neighbor (inf there)."""
    bl, bli, br, bri = brute_force_left_right(T, m)
    big = np.sqrt(2.0 * m * (1 + 1e12))
    return [np.where(np.isfinite(bl), bl, big), bli, np.where(np.isfinite(br), br, big), bri]


@pytest.mark.parametrize("name", ["random_walk", "motifs"])
def test_left_right_matches_mpx_hybrid(name):
    T, m, band, chunk = _series(name)
    ours, counts = _left_right(T, m, band, chunk)
    assert [o.dtype for o in ours] == [np.float64, np.int32] * 2
    cfg = mpx.MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=band,
                                  chunk=chunk, tile_rows=8, tile_cols=chunk)
    _assert_sides(T, m, ours, mpx_hybrid.compute_left_right_f64_hybrid(T, cfg))
    assert counts["pass_b"] == "sparse" and counts["capture_bytes"] > 0


@pytest.mark.parametrize("name", ["random_walk", "motifs"])
def test_left_right_matches_mpx_strict(name):
    T, m, band, chunk = _series(name)
    ours, _ = _left_right(T, m, band, chunk)
    cfg = mpx.MatrixProfileConfig(m=m, dtype="float64", kernel="mxu", band=band,
                                  chunk=chunk, tile_rows=8, tile_cols=chunk)
    ref = mpx.compute_matrix_profile(T, config=cfg, left_right=True)
    _assert_sides(T, m, ours, [np.asarray(r) for r in ref])


@pytest.mark.parametrize("name", ["random_walk", "motifs", "constant"])
def test_left_right_matches_brute_force(name):
    T, m, band, chunk = _series(name)
    ours, _ = _left_right(T, m, band, chunk)
    _assert_sides(T, m, ours, _brute(T, m))
    # The first excl windows have no left neighbor, the last excl no right.
    excl = m // 4
    assert (ours[1][:excl] == -1).all() and (ours[3][-excl:] == -1).all()
    if name == "constant":
        inside = np.arange(100, 180 - m + 1)
        assert (ours[1][inside] == -1).all() and (ours[3][inside] == -1).all()


def test_left_right_near_constant_level_matches_strict():
    """A plateau with fine detail on it (windows whose spread is small
    beside their level, as in test_torch_hybrid.py): each side equals the
    strict float64 sweep's."""
    t = np.arange(1024.0)
    T = 1000 + np.tanh((t - 512) / 80) + 1e-3 * np.sin(t / 11)
    for m in (16, 32):
        ours, _ = _left_right(T, m, 64, 128)
        cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="mxu", band=64, chunk=128,
                                  device="cpu")
        ref = [o.numpy() for o in compute_matrix_profile(T, config=cfg, left_right=True)]
        _assert_sides(T, m, ours, ref)


@pytest.mark.parametrize("case", ["pass_c", "row_scan"])
def test_sided_escalations_match_brute_force(monkeypatch, case):
    """80 repeats of a motif: every window has 79 near-equal neighbors, far
    past the 8 capture slots.  With plateau runs off (RUNCAP = 0) they go
    to the sided pass C; with PASS_C_K = 2 on to the sided row scan.  Each
    path is counted on both sides and the profiles held to the brute
    force."""
    monkeypatch.setattr(hybrid, "RUNCAP", 0)
    monkeypatch.setattr(hybrid, "PASS_C_K", 128 if case == "pass_c" else 2)
    T, m = _motifs(80, 13), 16
    ours, counts = _left_right(T, m, 64, 128)
    _assert_sides(T, m, ours, _brute(T, m))
    for side in ("left", "right"):
        assert counts[f"plateau_rows_{side}"] == 0
        assert counts[f"pass_c_rows_{side}"] > 0
        scans = counts[f"row_scan_rows_{side}"]
        assert scans == 0 if case == "pass_c" else scans > 0, counts


def test_sided_row_scan_matches_numpy():
    """The sided float64 row scan against a numpy scan of the same pairs:
    the first maximum on a tie, -1 where a side is empty."""
    T = random_walk(700, seed=4)
    T[300:360] = T[300]
    m = 24
    w = T.shape[0] - m + 1
    excl = m // 4
    s = precompute_statistics_numpy(T, m)
    ops = tuple(torch.from_numpy(np.asarray(a, np.float64)) for a in (T, s["mu"], s["inv"]))
    rows = np.array([0, 1, excl, 300, 320, 350, w // 2, w - excl, w - 1])
    win = np.lib.stride_tricks.sliding_window_view(T, m) - s["mu"][:, None]
    with np.errstate(invalid="ignore"):
        P = (win[rows] @ win.T) * s["inv"][rows][:, None] * s["inv"][None, :]
    fin = np.isfinite(s["inv"])
    delta = np.arange(w)[None, :] - rows[:, None]
    for side in (1, -1):
        zone = side * delta >= excl
        Ps = np.where(zone & fin[None, :] & fin[rows][:, None], P, -1e12)
        ref_i = np.where(Ps.max(1) > -1e12, Ps.argmax(1), -1)
        got_P, got_I = hybrid._row_scan(*ops, m, w, excl, torch.from_numpy(rows), side=side)
        np.testing.assert_array_equal(got_I.numpy(), ref_i)
        np.testing.assert_allclose(got_P.numpy(), Ps.max(1), rtol=0, atol=1e-12)


def test_per_side_thresholds_match_mpx():
    import jax.numpy as jnp

    from mpx.ops.precompute import precompute_statistics as mpx_precompute

    T, m, band, chunk = _series("random_walk")
    w = T.shape[0] - m + 1
    grid = make_job_grid(w, band, chunk)
    margin = hybrid.default_margin(m)
    s = mpx_precompute(T, m, band=band, chunk=chunk, dtype="float32", windows=True)
    pw = s.mu.shape[0]
    ref = mpx_hybrid.run_max_jobs(s, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                                  jnp.float32(margin), S=band, W=chunk, m=m, w=w, tr=8,
                                  tc=chunk, pw=pw, pwc=pw, combine=False)
    stats, _ = hybrid.hybrid_statistics(T, m, band=band, chunk=chunk, device="cpu")
    ours, cap = hybrid.run_max_jobs(stats, grid.r0, grid.k0, margin, S=band, W=chunk, m=m,
                                    w=w, pw=stats.mu.shape[0], combine=False)
    assert cap is not None
    for got, exp in zip(ours, ref):
        got, exp = got.numpy()[:w], np.asarray(exp)[:w]
        assert (np.isinf(got) == np.isinf(exp)).all()
        fin = np.isfinite(exp)
        np.testing.assert_allclose(got[fin], exp[fin], rtol=0, atol=1e-5)
    # Each side's threshold is at most the self-join's (from the larger
    # maximum), or +inf where that side has no valid pair.
    combined, _ = hybrid.run_max_jobs(stats, grid.r0, grid.k0, margin, S=band, W=chunk,
                                      m=m, w=w, pw=stats.mu.shape[0])
    assert all(bool(((side <= combined) | side.isinf()).all()) for side in ours)


def test_left_right_driver_and_cli(tmp_path):
    """``compute --left-right --kernel hybrid`` writes the four files mpx's
    CLI writes, within 1e-8 and the tie rule; a float32 request is the
    float64 result cast down; pass A is the plain sweep once a job."""
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    common = ["compute", "-i", inp, "-m", "16", "--dtype", "float64", "--kernel",
              "hybrid", "--band", "256", "--chunk", "512", "--left-right"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    jobs = len(make_job_grid(1024 - 15, 256, 512).r0)
    calls, launches = counters()["calls.mxu"], counters()["launches.k1"]
    assert port_main(common + ["-o", ours, "--device", "cpu"]) == 0
    assert counters()["calls.mxu"] - calls == jobs and counters()["launches.k1"] == launches
    assert mpx_main(common + ["-o", ref]) == 0
    T = read_series(inp)
    for suffix in (".left", ".right"):
        files = [read_binary(base + suffix + ext, kind) for base in (ours, ref)
                 for ext, kind in ((".mpb", "double"), (".mpib", "int"))]
        assert files[0].shape == files[2].shape == (1024 - 15,)
        assert_profile_close(T, 16, *files, eps=EPS)
    f64, _ = _left_right(T, 16, 256, 512)
    f32, _ = _left_right(T, 16, 256, 512, dtype="float32")
    for a, b in zip(f32, f64):
        assert a.dtype == (np.float32 if b.dtype == np.float64 else np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("left_right", [False, True])
def test_dense_route_without_captures_matches_sparse(monkeypatch, left_right):
    """With SPARSE_MAX_W at or below the width, pass A keeps no captures
    and pass B sweeps every job densely: the same profiles as the sparse
    route, for the self-join and the left/right profiles."""
    T, m, band, chunk = random_walk(1024, seed=31), 16, 64, 128
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=band,
                              chunk=chunk, device="cpu")
    out, counts = {}, {}
    run_max_jobs = hybrid.run_max_jobs
    for route, gate in (("sparse", hybrid.SPARSE_MAX_W), ("dense", T.shape[0] - m + 1)):
        monkeypatch.setattr(hybrid, "SPARSE_MAX_W", gate)
        captured = []
        monkeypatch.setattr(hybrid, "run_max_jobs", lambda *a, **k: captured.append(
            k["capture"]) or run_max_jobs(*a, **k))
        prof = BenchmarkProfile()
        out[route] = [o.numpy() for o in compute_matrix_profile(
            T, config=cfg, profile=prof, left_right=left_right)]
        counts[route] = dict(prof.counts, capture=captured)
    jobs = len(make_job_grid(T.shape[0] - m + 1, band, chunk).r0)
    assert counts["sparse"]["capture"] == [True] and counts["dense"]["capture"] == [False]
    assert counts["dense"]["pass_b"] == "dense" and counts["dense"]["capture_bytes"] == 0
    assert counts["dense"]["dense_jobs"] == jobs
    assert counts["sparse"]["capture_bytes"] == hybrid.capture_bytes(jobs, band, chunk)
    for a, b in zip(out["sparse"], out["dense"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,free,ok", [
    (2**23 - 1, None, True), (2**23, None, False),
    (1000, 64 << 30, True), (1000, 4 << 30, False),
])
def test_sparse_gate(monkeypatch, w, free, ok):
    """mpx's width gate, and on a card the captures' fit in free memory
    less the stated headroom (the card's answer stubbed here)."""
    nbytes = 1 << 30
    if free is None:
        assert hybrid._sparse_ok(w, nbytes, "cpu") is ok
        return
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, 80 << 30))
    assert hybrid._sparse_ok(w, nbytes, torch.device("cuda")) is ok


def test_full_precision_matmul_restores_the_flag():
    """The port clears TF32 only around its own products and leaves the
    caller's setting as it found it, also when the block raises."""
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    try:
        for setting in (True, False):
            flag.allow_tf32 = setting
            with full_precision_matmul():
                assert flag.allow_tf32 is False
            assert flag.allow_tf32 is setting
            with pytest.raises(RuntimeError), full_precision_matmul():
                raise RuntimeError
            assert flag.allow_tf32 is setting
        flag.allow_tf32 = True
        T, m, band, chunk = _series("motifs")
        _left_right(T, m, band, chunk)
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = saved
