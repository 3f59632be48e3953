"""mpx_torch's benchmark (``mpx_torch/bench.py``, ``python -m mpx_torch
bench``) on the CPU: its validation against the golden oracle, corrupted
profiles and ties, and the four-key JSON last line."""

import json

import numpy as np
import pytest

from mpx.reference import compute_matrix_profile_reference
from mpx_torch import bench, matrix_profile
from mpx_torch.cli import main as port_main
from tests.conftest import random_walk


def _strict(T, m):
    """The port's strict float64 profile (the plain sweep on the CPU)."""
    return matrix_profile(T, m, dtype="float64", kernel="mxu", band=256, chunk=512,
                          device="cpu")


def test_validate_sampled_rows_passes_on_the_golden():
    T = random_walk(1500, seed=2)
    m = 32
    MP, MPI = compute_matrix_profile_reference(T, m)
    res = bench.validate_sampled_rows(T, m, MP, MPI, k=200, seed=3)
    assert res["rows"] == 200 and res["max_abs_err"] < 1e-10 and res["tol"] == 1e-8


def test_validate_sampled_rows_checks_rows_without_neighbor():
    """Zero-variance windows have no neighbor: index -1 passes there, any
    other index fails."""
    T = random_walk(1500, seed=2)
    T[600:700] = T[600]
    m = 32
    MP, MPI = _strict(T, m)
    w = MP.shape[0]
    res = bench.validate_sampled_rows(T, m, MP, MPI, k=w)
    assert res["max_abs_err"] < 1e-10 and (MPI == -1).sum() == 100 - m + 1
    bad = MPI.copy()
    bad[620] = 0
    with pytest.raises(bench.ValidationError, match="1 non-tie index"):
        bench.validate_sampled_rows(T, m, MP, bad, k=w)


def test_validate_sampled_rows_raises_on_corruption():
    T = random_walk(1200, seed=5)
    m = 24
    MP, MPI = compute_matrix_profile_reference(T, m)
    w = MP.shape[0]
    bad = MP.copy()
    bad[::7] += 1e-6  # a distance off by more than 1e-8
    with pytest.raises(bench.ValidationError, match="distance"):
        bench.validate_sampled_rows(T, m, bad, MPI, k=w)
    bad = MPI.copy()
    bad[::5] = (bad[::5] + 100) % w  # a neighbor that is not a tie
    with pytest.raises(bench.ValidationError, match="non-tie index"):
        bench.validate_sampled_rows(T, m, MP, bad, k=w)


def test_validate_sampled_rows_accepts_equidistant_ties():
    """A series of exact repeats: windows at the same phase of two repeats
    are at the same distance, so either index is right."""
    motif = np.random.default_rng(6).standard_normal(50)
    T = np.tile(motif, 6)
    m = 16
    MP, MPI = _strict(T, m)
    w = MP.shape[0]
    other = MPI.copy()
    for i in range(w):
        later = [j for j in (i + 50, i + 100, i - 50, i - 100) if 0 <= j < w and j != MPI[i]]
        if later:
            other[i] = later[0]
    assert (other != MPI).sum() > w // 2
    # At distance 0, sqrt(2m(1 - P)) turns one rounding of P into ~1e-7 of
    # distance, so the check runs at 1e-6 here.
    res = bench.validate_sampled_rows(T, m, MP, other, k=w, tol=1e-6)
    assert res["tie_indices"] > w // 2


def test_bench_main_prints_the_four_key_line(capsys):
    assert port_main(["bench", "-n", "2048", "-m", "32", "--dtype", "float64",
                      "--kernel", "hybrid", "--band", "256", "--chunk", "512",
                      "--validate", "16", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    detail, last = json.loads(lines[-2]), json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "pairs/s" and last["value"] > 0
    assert last["vs_baseline"] == last["value"] / bench.BASELINE_PAIRS_PER_SEC
    assert "n=2048, m=32, float64" in last["metric"]
    assert detail["validation"]["rows"] == 16 and detail["validation"]["tol"] == 1e-8
    assert detail["counts"]["jobs"] > 0  # the hybrid's counts


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("ap32", 1e-8)])
def test_run_benchmark_validates_what_it_computed(dtype, tol):
    res = bench.run_benchmark(n=1500, m=16, dtype=dtype, band=256, chunk=512,
                              validate=32, warmup=False, device="cpu")
    assert res["validation"]["tol"] == tol and res["validation"]["rows"] == 32
    w = 1500 - 16 + 1
    assert res["pairs"] == w * (w - 1) / 2 and res["compute_s"] > 0
    assert res["pairs_per_sec"] == res["pairs"] / res["wall_s"]


def test_suite_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        bench.main(["--suite", "--device", "cpu"])
