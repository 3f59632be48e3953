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


def _suite_row(name):
    return next(r for r in bench.SUITE if r["name"] == name)


def test_suite_names_and_shapes_equal_mpxs():
    """The port's SUITE is mpx's, row for row, less mpx's ``note`` text."""
    from mpx.bench import SUITE as MPX_SUITE

    assert [r["name"] for r in bench.SUITE] == [r["name"] for r in MPX_SUITE]
    for ours, theirs in zip(bench.SUITE, MPX_SUITE):
        assert ours == {k: v for k, v in theirs.items() if k != "note"}


def test_suite_only_runs_the_named_row_and_writes_table_and_out(capsys, tmp_path):
    out = tmp_path / "suite.json"
    assert bench.main(["--suite", "--only", "vanilla-f32-8192", "--device", "cpu",
                       "--table", "--out", str(out)]) == 0
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert lines[0] == "device: cpu"
    rows = json.loads("\n".join(lines[1:]))
    assert rows == json.loads(out.read_text())
    (row,) = rows
    assert row["name"] == "vanilla-f32-8192" and "failed" not in row
    assert (row["n"], row["m"], row["dtype"]) == (8192, 32, "float32")
    assert row["validation"]["rows"] == 64 and row["validation"]["tol"] == 2e-3
    assert row["vs_baseline"] == row["pairs_per_sec"] / bench.BASELINE_PAIRS_PER_SEC
    prov = row["provenance"]
    assert {"mpx_torch", "torch", "cuda", "device", "allow_tf32", "measured_at",
            "commit"} <= set(prov)
    assert prov["device"] == "device: cpu"
    assert prov["native"] is True and prov["stats_backend"] == "numpy"
    assert "| vanilla-f32-8192 | 8,192 | 32 | float32 |" in cap.err


def test_suite_skips_huge_rows_unless_named(monkeypatch):
    ran = []
    monkeypatch.setattr(bench, "run_benchmark",
                        lambda **kw: ran.append(kw) or {"pairs_per_sec": 1.0, "wall_s": 1.0})
    monkeypatch.setattr(bench, "SUITE", [_suite_row("vanilla-f32-8192"),
                                         _suite_row("pod-f32-16777216")])
    assert [r["name"] for r in bench.run_suite(device="cpu")] == ["vanilla-f32-8192"]
    rows = bench.run_suite(names=["pod-f32-16777216"], device="cpu")
    assert [r["name"] for r in rows] == ["pod-f32-16777216"]
    assert ran[-1]["kernel"] == "mxu" and ran[-1]["warmup"] is False
    assert ran[-1]["validate"] == 32 and "huge" not in ran[-1]


def test_suite_reraises_validation_errors_and_records_other_failures(monkeypatch):
    def corrupt(**kw):
        raise bench.ValidationError("sampled-row validation FAILED")

    def flaky(**kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(bench, "SUITE", [_suite_row("vanilla-f32-8192")])
    monkeypatch.setattr(bench, "run_benchmark", corrupt)
    with pytest.raises(bench.ValidationError):
        bench.run_suite(device="cpu")
    monkeypatch.setattr(bench, "run_benchmark", flaky)
    seen = []
    rows = bench.run_suite(device="cpu", on_row=seen.append)
    assert rows == seen and rows[0]["failed"] == "RuntimeError('out of memory')"
    assert "measured_at" in rows[0]["provenance"]


# Each runner at a tiny size, with the keys mpx's runner returns.
RUNNERS = [
    ("run_streaming_benchmark", dict(n=600, m=16, append=16, rounds=4),
     {"append_ms", "recompute_pairs", "appends", "baseline_model"}),
    ("run_topk_benchmark", dict(n=700, m=16, k=3, band=256, chunk=512, validate=8),
     {"k"}),
    ("run_thresh_benchmark", dict(n=700, m=16, threshold=0.5, band=256, chunk=512,
                                  validate=8), {"threshold"}),
    ("run_damp_benchmark", dict(n=700, m=16, band=256, chunk=512, validate=8), set()),
    ("run_mstamp_benchmark", dict(n=500, m=16, d=3, band=256, chunk=512, validate=4),
     {"d", "work_factor", "baseline_model"}),
    ("run_batch_benchmark", dict(n=400, m=16, b=5, band=128, chunk=128, validate=2),
     {"b", "series_ms", "baseline_model"}),
    ("run_matrix_benchmark", dict(n=700, m=16, mwidth=8, mheight=8, band=256, chunk=512,
                                  validate=8), {"mwidth", "mheight", "matrix_max_corr"}),
    ("run_merlin_benchmark", dict(n=500, lo=8, hi=11, validate=4),
     {"lengths", "top_discord"}),
]


@pytest.mark.parametrize("name,kwargs,extra", RUNNERS, ids=[r[0] for r in RUNNERS])
def test_runner_runs_and_validates_at_a_tiny_size(name, kwargs, extra):
    res = getattr(bench, name)(device="cpu", **kwargs)
    assert {"n", "m", "dtype", "pairs", "wall_s", "pairs_per_sec", "validation",
            "device"} | extra <= set(res)
    val = res["validation"]
    assert res["device"] == "cpu" and res["wall_s"] > 0
    assert val.get("rows", val.get("series")) > 0
    assert res["pairs_per_sec"] == res["pairs"] / res["wall_s"]


def test_thresh_runner_catches_a_corrupt_sum(monkeypatch):
    import mpx_torch.thresh as thresh

    real = thresh.compute_sum_thresh

    def corrupt(*a, **kw):
        sums, cnts = real(*a, **kw)
        return sums + 1.0, cnts

    monkeypatch.setattr(thresh, "compute_sum_thresh", corrupt)
    with pytest.raises(bench.ValidationError, match="thresh"):
        bench.run_thresh_benchmark(n=600, m=16, threshold=0.5, band=256, chunk=512,
                                   validate=8, device="cpu")


def test_run_benchmark_takes_the_ring_rows_shards():
    res = bench.run_benchmark(n=1500, m=16, band=256, chunk=512, shards=1,
                              shard_mode="ring", validate=16, warmup=False, device="cpu")
    assert res["validation"]["rows"] == 16 and res["validation"]["tol"] == 2e-3


def test_suite_table_renders_every_row_shape():
    rows = [
        {"name": "a", "n": 8192, "m": 32, "dtype": "float32", "wall_s": 0.5,
         "pairs_per_sec": 6.0e10, "vs_baseline": 2.0},
        {"name": "s", "n": 262144, "m": 256, "dtype": "float32", "wall_s": 0.1,
         "append_ms": 1.25, "pairs_per_sec": 1e9, "vs_baseline": 7.5},
        {"name": "s2", "n": 262144, "m": 256, "dtype": "float32", "wall_s": 0.1,
         "append_ms": 1.25, "pairs_per_sec": 1e9},
        {"name": "f", "failed": "RuntimeError()", "provenance": {"measured_at": "T"}},
    ]
    lines = bench.suite_table(rows).splitlines()
    assert lines[0].startswith("| config | n | m | dtype |") and len(lines) == 6
    assert lines[2] == "| a | 8,192 | 32 | float32 | 0.500 | 6.0000e+10 | 2.000x |"
    assert "1.250 ms/append" in lines[3] and "7.5x vs recompute" in lines[3]
    assert "(incremental tier)" in lines[4]
    assert lines[5] == "| f | — | — | — | FAILED (T) | — | — |"
