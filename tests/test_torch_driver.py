"""mpx_torch.compute_matrix_profile (CPU) against mpx and the golden oracle.

The same series, band and chunk go through both packages (mpx with
``kernel='mxu'``, the plain sweep the port's CPU path mirrors, and with
``kernel='xla'`` for the port's recurrence tier).
Tolerances are the repo's profile tolerances (tests/helpers.py):
distances within 1e-8 (float64) and 2e-3 (float32), indices equal or
equidistant.
"""

import os

import numpy as np
import pytest

import mpx
from mpx.cli import main as mpx_main
from mpx_torch import MatrixProfileConfig, compute_matrix_profile, matrix_profile
from mpx_torch.cli import main as port_main
from mpx_torch.dtypes import distance_epsilon
from mpx_torch.io.tsb import read_binary, read_series
from mpx_torch.utils.profile import counters
from tests.conftest import DATA_DIR
from tests.helpers import assert_profile_close

# (dataset path under data/, samples used, m, band, chunk)
DATASETS = [
    ("test/1024.txt", None, 16, 256, 512),
    ("test/16384.txt", None, 128, 1024, 2048),
    ("test/small128_syn.txt", None, 16, 4096, 16384),
    ("real/ecg-heartbeat-av.txt", 2000, 64, 512, 1024),
]


def _golden(T, m):
    from mpx import native
    from mpx.reference import compute_matrix_profile_reference

    if native.is_available():
        return native.golden_scamp(T, m)
    return compute_matrix_profile_reference(T, m)


def _load(path, limit):
    T = read_series(os.path.join(DATA_DIR, path))
    return T if limit is None else T[:limit]


def _np(out):
    return [np.asarray(o.numpy()) for o in out]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("path,limit,m,band,chunk", DATASETS)
def test_profile_matches_mpx_and_golden(path, limit, m, band, chunk, dtype):
    T = _load(path, limit)
    eps = distance_epsilon(dtype)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device="cpu")
    MP, MPI = _np(compute_matrix_profile(T, config=cfg))
    assert MP.dtype == np.dtype(dtype) and MPI.dtype == np.int32
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel="mxu", band=band,
                                      chunk=chunk)
    MP_ref, MPI_ref = (np.asarray(x) for x in mpx.compute_matrix_profile(T, config=ref_cfg))
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref, eps=eps)
    MP_gold, MPI_gold = _golden(T, m)
    assert_profile_close(T, m, MP, MPI, MP_gold, MPI_gold, eps=eps)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("path,limit,m,band,chunk",
                         [DATASETS[0], DATASETS[3]])
def test_left_right_matches_mpx(path, limit, m, band, chunk, dtype):
    T = _load(path, limit)
    eps = distance_epsilon(dtype)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device="cpu")
    ours = _np(compute_matrix_profile(T, config=cfg, left_right=True))
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel="mxu", band=band,
                                      chunk=chunk)
    ref = [np.asarray(x) for x in
           mpx.compute_matrix_profile(T, config=ref_cfg, left_right=True)]
    for side in (0, 2):  # left, right
        assert_profile_close(T, m, ours[side], ours[side + 1], ref[side],
                             ref[side + 1], eps=eps)


def test_matrix_profile_wrapper_and_kernels_agree():
    """matrix_profile returns numpy; kernel='mxu_fused' on CPU tensors is
    the plain path, so all kernel names give one profile."""
    T = _load("test/1024.txt", None)
    outs = [matrix_profile(T, 16, dtype="float64", kernel=k, band=128,
                           chunk=256, device="cpu")
            for k in ("auto", "mxu", "mxu_fused")]
    for MP, MPI in outs:
        assert isinstance(MP, np.ndarray) and isinstance(MPI, np.ndarray)
        np.testing.assert_array_equal(MP, outs[0][0])
        np.testing.assert_array_equal(MPI, outs[0][1])


def test_precomputed_stats_are_used():
    from mpx_torch.ops.precompute import precompute_statistics

    T = _load("test/1024.txt", None)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=128, chunk=256, device="cpu")
    stats = precompute_statistics(T, 16, band=128, chunk=256, dtype="float64",
                                  device="cpu")
    a = _np(compute_matrix_profile(T, config=cfg, stats=stats))
    b = _np(compute_matrix_profile(T, config=cfg))
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError):
        compute_matrix_profile(T, config=MatrixProfileConfig(
            m=16, dtype="float32", band=128, chunk=256, device="cpu"), stats=stats)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("left_right", [False, True])
def test_cli_compute_matches_mpx_files(tmp_path, dtype, left_right):
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    common = ["compute", "-i", inp, "-m", "16", "--dtype", dtype,
              "--band", "256", "--chunk", "512"]
    lr = ["--left-right"] if left_right else []
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(common + lr + ["-o", ours, "--device", "cpu"]) == 0
    assert mpx_main(common + lr + ["-o", ref, "--kernel", "mxu"]) == 0
    T = read_series(inp)
    for suffix in ((".left", ".right") if left_right else ("",)):
        MP = read_binary(ours + suffix + ".mpb", "double")
        MPI = read_binary(ours + suffix + ".mpib", "int")
        MP_ref = read_binary(ref + suffix + ".mpb", "double")
        MPI_ref = read_binary(ref + suffix + ".mpib", "int")
        assert MP.shape == MP_ref.shape == (T.shape[0] - 15,)
        assert_profile_close(T, 16, MP, MPI, MP_ref, MPI_ref,
                             eps=distance_epsilon(dtype))


def test_cli_prints_without_output(capsys):
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    assert port_main(["compute", "-i", inp, "-m", "16", "--device", "cpu",
                      "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "(1009 total; pass -o to persist)" in out
    assert "2. Compute [mxu]" in out


@pytest.mark.parametrize("w,band,chunk", [(113, 120, 2048), (1009, 256, 512),
                                          (16257, 1024, 2048), (5000, 4096, 16384)])
def test_job_grid_and_shrink_match_mpx(w, band, chunk):
    from mpx.config import make_job_grid as mpx_grid
    from mpx.config import pad_job_grid as mpx_pad
    from mpx_torch.config import make_job_grid, pad_job_grid

    ours, ref = make_job_grid(w, band, chunk), mpx_grid(w, band, chunk)
    np.testing.assert_array_equal(ours.r0, ref.r0)
    np.testing.assert_array_equal(ours.k0, ref.k0)
    for a, b in zip(pad_job_grid(ours, 7, w), mpx_pad(ref, 7, w)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cfg = MatrixProfileConfig(m=16, band=band, chunk=chunk, device="cpu").shrink_to(w)
    ref_cfg = mpx.MatrixProfileConfig(m=16, band=band, chunk=chunk).shrink_to(w)
    assert (cfg.band, cfg.chunk) == (ref_cfg.band, ref_cfg.chunk)


# The recurrence tier: kernel='xla' (plain) and kernel='pallas' (K3, which
# takes the plain version on the CPU) against mpx's kernel='xla'.
RECURRENCE_DATASETS = [DATASETS[0], DATASETS[2], DATASETS[3]]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("path,limit,m,band,chunk", RECURRENCE_DATASETS)
def test_recurrence_profile_matches_mpx_and_golden(path, limit, m, band, chunk,
                                                   kernel, dtype):
    T = _load(path, limit)
    eps = distance_epsilon(dtype)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band,
                              chunk=chunk, device="cpu")
    MP, MPI = _np(compute_matrix_profile(T, config=cfg))
    assert MP.dtype == np.dtype(dtype) and MPI.dtype == np.int32
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel="xla", band=band,
                                      chunk=chunk)
    MP_ref, MPI_ref = (np.asarray(x) for x in mpx.compute_matrix_profile(T, config=ref_cfg))
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref, eps=eps)
    MP_gold, MPI_gold = _golden(T, m)
    assert_profile_close(T, m, MP, MPI, MP_gold, MPI_gold, eps=eps)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("path,limit,m,band,chunk", [DATASETS[0], DATASETS[3]])
def test_recurrence_left_right_matches_mpx(path, limit, m, band, chunk, kernel, dtype):
    T = _load(path, limit)
    eps = distance_epsilon(dtype)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band,
                              chunk=chunk, device="cpu")
    ours = _np(compute_matrix_profile(T, config=cfg, left_right=True))
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel="xla", band=band,
                                      chunk=chunk)
    ref = [np.asarray(x) for x in
           mpx.compute_matrix_profile(T, config=ref_cfg, left_right=True)]
    for side in (0, 2):  # left, right
        assert_profile_close(T, m, ours[side], ours[side + 1], ref[side],
                             ref[side + 1], eps=eps)


def test_recurrence_stages_no_windows(monkeypatch):
    """The recurrence reads only T, mu, df, dg and inv: no window matrix is
    built for it, and staged stats without one serve it (not K1)."""
    import mpx_torch.ops.precompute as pre

    T = _load("test/1024.txt", None)
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="pallas", band=128,
                              chunk=256, device="cpu")
    ref = _np(compute_matrix_profile(T, config=cfg))
    stats = pre.precompute_statistics(T, 16, band=128, chunk=256, dtype="float64",
                                      device="cpu", windows=False, exact_mean=True)
    assert stats.windows is None

    def no_windows(*args, **kwargs):
        raise AssertionError("the recurrence tier built the window matrix")

    monkeypatch.setattr(pre, "build_windows", no_windows)
    calls = counters()["calls.xla"]
    got = _np(compute_matrix_profile(T, config=cfg, stats=stats))
    assert counters()["calls.xla"] > calls
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError, match="windows"):
        compute_matrix_profile(T, config=MatrixProfileConfig(
            m=16, dtype="float64", band=128, chunk=256, device="cpu"), stats=stats)


def test_auto_f64_large_m_takes_the_recurrence(monkeypatch):
    """mpx's policy: float64 with m > MXU_MAX_M runs the recurrence (the
    plain version on the CPU), with no window matrix."""
    import mpx_torch.ops.precompute as pre
    from mpx_torch.kernels import MXU_MAX_M

    m = MXU_MAX_M + 4
    T = np.cumsum(np.random.default_rng(3).standard_normal(m + 300))
    monkeypatch.setattr(pre, "build_windows", None)  # any call would raise
    calls, mxu_calls = counters()["calls.xla"], counters()["calls.mxu"]
    MP, MPI = matrix_profile(T, m, dtype="float64", device="cpu")
    assert counters()["calls.xla"] > calls and counters()["calls.mxu"] == mxu_calls
    MP_ref, MPI_ref = (np.asarray(x) for x in mpx.compute_matrix_profile(
        T, config=mpx.MatrixProfileConfig(m=m, dtype="float64", kernel="xla")))
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref, eps=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cli_compute_pallas_matches_mpx_files(tmp_path, dtype):
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    common = ["compute", "-i", inp, "-m", "16", "--dtype", dtype,
              "--band", "256", "--chunk", "512"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(common + ["-o", ours, "--device", "cpu", "--kernel", "pallas"]) == 0
    assert mpx_main(common + ["-o", ref, "--kernel", "xla"]) == 0
    T = read_series(inp)
    MP, MPI = read_binary(ours + ".mpb", "double"), read_binary(ours + ".mpib", "int")
    MP_ref = read_binary(ref + ".mpb", "double")
    MPI_ref = read_binary(ref + ".mpib", "int")
    assert MP.shape == MP_ref.shape == (T.shape[0] - 15,)
    assert_profile_close(T, 16, MP, MPI, MP_ref, MPI_ref, eps=distance_epsilon(dtype))
