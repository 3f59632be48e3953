"""Checkpoint / resume of mpx_torch (``mpx_torch.checkpoint``, on the CPU):
the strict group loop (``mxu``, ``xla``) and the hybrid float64 tier killed
in pass A, in pass B and at the start of pass B, each resumed run equal
bit for bit to an uninterrupted one and within 1e-8 (float64) / 2e-3
(float32) of mpx's checkpointed runs; mismatched and corrupt checkpoints
start fresh; no temp file is left behind.
"""

import os

import numpy as np
import pytest

import mpx
from mpx.checkpoint import compute_hybrid_with_checkpoint as mpx_hybrid_ckpt
from mpx.checkpoint import compute_with_checkpoint as mpx_ckpt
from mpx_torch import MatrixProfileConfig, checkpoint, hybrid, make_job_grid
from mpx_torch.checkpoint import (
    HybridCheckpoint,
    compute_hybrid_with_checkpoint,
    compute_with_checkpoint,
)
from mpx_torch.utils.profile import BenchmarkProfile
from tests.helpers import assert_profile_close

EPS = {"float64": 1e-8, "float32": 2e-3}


class _Killed(RuntimeError):
    pass


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _files(tmp_path):
    return sorted(os.listdir(tmp_path))


@pytest.fixture
def small_groups(monkeypatch):
    """Groups of 8 jobs, so a small problem spans several saves."""
    monkeypatch.setattr(hybrid, "CKPT_JOBS", 8)


@pytest.mark.parametrize("kernel,dtype", [("mxu", "float32"), ("mxu", "float64"),
                                          ("xla", "float64")])
def test_strict_resume_is_bit_equal_and_matches_mpx(tmp_path, monkeypatch, kernel, dtype):
    T = _walk(1500, 61)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=64, chunk=128,
                              device="cpu")
    path = str(tmp_path / "ck.npz")
    MP0, MPI0 = compute_with_checkpoint(T, cfg, path, group_jobs=16)
    assert isinstance(MP0, np.ndarray) and _files(tmp_path) == []

    saves = []
    real_save = checkpoint._save

    def dying_save(*args):
        real_save(*args)
        saves.append(args[3])
        if len(saves) == 3:
            raise _Killed

    monkeypatch.setattr(checkpoint, "_save", dying_save)
    with pytest.raises(_Killed):
        compute_with_checkpoint(T, cfg, path, group_jobs=16)
    monkeypatch.setattr(checkpoint, "_save", real_save)
    assert _files(tmp_path) == ["ck.npz"]  # no stray temp file
    assert int(np.load(path)["next_group"]) == 3

    prof = BenchmarkProfile()
    MP1, MPI1 = compute_with_checkpoint(T, cfg, path, group_jobs=16, profile=prof)
    np.testing.assert_array_equal(MP0, MP1)
    np.testing.assert_array_equal(MPI0, MPI1)
    assert _files(tmp_path) == []
    # the resumed run swept only the groups after the third
    jobs = len(make_job_grid(1500 - m + 1, 64, 128).r0)
    assert len(prof._categories[f"2. Compute [{kernel}]"]) == -(-jobs // 16) - 3

    MPr, MPIr = mpx_ckpt(T, mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel,
                                                    band=64, chunk=128),
                         str(tmp_path / "mpx.npz"), group_jobs=16)
    assert_profile_close(T, m, MP1, MPI1, MPr, MPIr, EPS[dtype])


def test_strict_checkpoint_equals_the_driver(tmp_path):
    from mpx_torch import compute_matrix_profile

    T = _walk(900, 62)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=64, device="cpu")
    MP, MPI = compute_with_checkpoint(T, cfg, str(tmp_path / "c.npz"), group_jobs=5)
    MPd, MPId = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    np.testing.assert_array_equal(MP, MPd)
    np.testing.assert_array_equal(MPI, MPId)


def _interrupting(kill_stage: str, after: int):
    """A HybridCheckpoint that dies after ``after`` saves in the given
    stage (``"begin_b"``: as pass B starts)."""

    class Interrupting(HybridCheckpoint):
        saves = 0

        def save_a(self, rmax, cmax, next_group):
            super().save_a(rmax, cmax, next_group)
            if kill_stage == "A":
                Interrupting.saves += 1
                if Interrupting.saves >= after:
                    raise _Killed

        def begin_b(self, thr):
            super().begin_b(thr)
            if kill_stage == "begin_b":
                raise _Killed

        def mark_done_and_save(self, rows_g, cols_g, r0s, k0s, keep=None):
            super().mark_done_and_save(rows_g, cols_g, r0s, k0s, keep=keep)
            if kill_stage == "B":
                Interrupting.saves += 1
                if Interrupting.saves >= after:
                    raise _Killed

    return Interrupting


@pytest.mark.parametrize("kill_stage,after,route", [
    ("A", 2, "sparse"), ("B", 2, "sparse"), ("begin_b", 0, "sparse"),
    # without captures (the width gate lowered): pass B's dense route saves
    ("B", 2, "dense"),
])
def test_hybrid_resume_is_bit_equal_and_matches_mpx(tmp_path, small_groups, monkeypatch,
                                                    kill_stage, after, route):
    if route == "dense":
        monkeypatch.setattr(hybrid, "SPARSE_MAX_W", 16)
    T = _walk(1500, 71)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=64, chunk=64,
                              device="cpu")
    path = str(tmp_path / "hy.npz")
    MP0, MPI0 = (o.numpy() for o in hybrid.compute_matrix_profile_f64_hybrid(T, cfg))

    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(T, cfg, path, _ckpt_cls=_interrupting(kill_stage, after))
    assert _files(tmp_path) == ["hy.npz"]
    stage = str(np.load(path)["stage"])
    assert stage == ("B" if kill_stage == "B" else "A")

    prof = BenchmarkProfile()
    MP1, MPI1 = compute_with_checkpoint(T, cfg, path, profile=prof)
    np.testing.assert_array_equal(MP0, MP1)
    np.testing.assert_array_equal(MPI0, MPI1)
    assert _files(tmp_path) == []
    if kill_stage == "B":
        assert "2. Compute [pass B resume dense]" in prof.category_totals()
    elif route == "sparse":
        # the jobs whose captures the crash lost swept densely
        assert prof.counts["dense_jobs"] >= (16 if kill_stage == "A" else prof.counts["jobs"])

    MPr, MPIr = mpx_hybrid_ckpt(T, mpx.MatrixProfileConfig(m=m, dtype="float64", band=64,
                                                           chunk=64),
                                str(tmp_path / "mpx.npz"))
    assert_profile_close(T, m, MP1, MPI1, MPr, MPIr, 1e-8)


def test_hybrid_float32_request_and_refusals(tmp_path, small_groups):
    T = _walk(1200, 73)
    cfg = MatrixProfileConfig(m=16, dtype="float32", kernel="hybrid", band=64, chunk=64,
                              device="cpu")
    MP, MPI = compute_with_checkpoint(T, cfg, str(tmp_path / "h.npz"), keep_checkpoint=True)
    assert MP.dtype == np.float32 and _files(tmp_path) == ["h.npz"]
    MP64, MPI64 = (o.numpy() for o in hybrid.compute_matrix_profile_f64_hybrid(T, cfg))
    np.testing.assert_array_equal(MP, MP64.astype(np.float32))
    np.testing.assert_array_equal(MPI, MPI64)
    ck = HybridCheckpoint(str(tmp_path / "x.npz"), "fp", make_job_grid(100, 64, 64))
    with pytest.raises(ValueError, match="self-join"):
        hybrid._run(T, cfg, margin=None, profile=None, left_right=True, ckpt=ck)


def test_mismatched_or_corrupt_checkpoints_start_fresh(tmp_path, small_groups, capsys):
    m = 16
    T1, T2 = _walk(1500, 74), _walk(1500, 75)
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=64, chunk=64,
                              device="cpu")
    path = str(tmp_path / "fp.npz")
    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(T1, cfg, path, _ckpt_cls=_interrupting("A", 1))
    MP, MPI = compute_hybrid_with_checkpoint(T2, cfg, path)
    assert "does not match" in capsys.readouterr().out
    MPe, MPIe = (o.numpy() for o in hybrid.compute_matrix_profile_f64_hybrid(T2, cfg))
    np.testing.assert_array_equal(MP, MPe)
    np.testing.assert_array_equal(MPI, MPIe)

    strict = MatrixProfileConfig(m=m, dtype="float64", band=64, chunk=64, device="cpu")
    with open(path, "wb") as f:
        f.write(b"not an npz")
    MP, MPI = compute_with_checkpoint(T2, strict, path, group_jobs=8)
    assert "unreadable" in capsys.readouterr().out
    assert_profile_close(T2, m, MP, MPI, MPe, MPIe, 1e-8)
    # another group size is another fingerprint
    compute_with_checkpoint(T2, strict, path, group_jobs=8, keep_checkpoint=True)
    compute_with_checkpoint(T2, strict, path, group_jobs=4)
    assert "does not match" in capsys.readouterr().out
    assert _files(tmp_path) == []


def test_input_quant_is_applied_before_the_fingerprint(tmp_path):
    """A run on the raw series resumes a checkpoint of the quantized one:
    the fingerprint covers what is computed."""
    from mpx_torch.io.apfixed import quantize

    T = _walk(600, 76)
    path = str(tmp_path / "q.npz")
    cfg = MatrixProfileConfig(m=16, dtype="ap32", band=64, chunk=64, device="cpu")
    MP, MPI = compute_with_checkpoint(quantize(T, "ap32"), cfg, path, group_jobs=4,
                                      keep_checkpoint=True)
    prof = BenchmarkProfile()
    MP2, MPI2 = compute_with_checkpoint(T, cfg, path, group_jobs=4, profile=prof)
    assert "2. Compute [mxu]" not in prof.category_totals()  # every group was done
    np.testing.assert_array_equal(MP, MP2)
    np.testing.assert_array_equal(MPI, MPI2)
    MPr, MPIr = mpx_ckpt(T, mpx.MatrixProfileConfig(m=16, dtype="ap32", kernel="mxu",
                                                    band=64, chunk=64),
                         str(tmp_path / "r.npz"), group_jobs=4)
    assert_profile_close(quantize(T, "ap32"), 16, MP, MPI, MPr, MPIr, 1e-8)
