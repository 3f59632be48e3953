"""The schedule-variant command lines of ``python -m mpx_torch``
(``--device cpu``) against ``python -m mpx``'s with the same arguments:
``compute --checkpoint`` (resuming a killed run), ``--approx`` and
``--allow-missing``, and the ``damp``, ``batch`` and ``floss``
subcommands: the same files within 1e-8 (float64) / 2e-3 (float32),
indices equal but between equidistant neighbours, the same printed
tables, and mpx's refusals of flag combinations.
"""

import os

import numpy as np
import pytest

from mpx.cli import main as mpx_main
from mpx_torch import MatrixProfileConfig, checkpoint
from mpx_torch.checkpoint import compute_with_checkpoint
from mpx_torch.cli import main as port_main
from mpx_torch.io.tsb import read_binary, write_binary
from tests.conftest import random_walk
from tests.helpers import assert_profile_close
from tests.test_damp import with_anomaly
from tests.test_floss import two_regime_series
from tests.test_missing import gapped_series

EPS = {"float32": 2e-3, "float64": 1e-8}


def _write(tmp_path, name, X):
    path = str(tmp_path / f"{name}.tsb")
    write_binary(path, X, "double")
    return path


def _files(base):
    return read_binary(base + ".mpb", "double"), read_binary(base + ".mpib", "int")


def _table(out):
    return [ln for ln in out.splitlines() if ln.startswith("  ")]


def test_compute_checkpoint_resumes_a_killed_run(tmp_path, monkeypatch):
    T = random_walk(1200, seed=21)
    path = _write(tmp_path, "t", T)
    ck = str(tmp_path / "run.npz")
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=128, device="cpu")
    real_save = checkpoint._save

    def dying_save(*args):
        real_save(*args)
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "_save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        compute_with_checkpoint(T, cfg, ck)
    monkeypatch.setattr(checkpoint, "_save", real_save)
    assert os.path.exists(ck)
    args = ["compute", "-i", path, "-m", "16", "--dtype", "float64", "--band", "64",
            "--chunk", "128"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + ["--checkpoint", ck, "-o", ours, "--device", "cpu"]) == 0
    assert not os.path.exists(ck)
    assert mpx_main(args + ["--checkpoint", str(tmp_path / "mpx.npz"), "--kernel", "mxu",
                            "-o", ref]) == 0
    MP, MPI = _files(ours)
    np.testing.assert_array_equal(MP, compute_with_checkpoint(T, cfg, ck)[0])
    assert_profile_close(T, 16, MP, MPI, *_files(ref), 1e-8)


def test_compute_approx_writes_mpxs_file(tmp_path, capsys):
    T = random_walk(900, seed=22)
    path = _write(tmp_path, "t", T)
    args = ["compute", "-i", path, "-m", "24", "--approx", "0.3", "--band", "32",
            "--chunk", "64", "--dtype", "float64"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + ["-o", ours, "--device", "cpu"]) == 0
    assert "of the job grid" in capsys.readouterr().out
    assert mpx_main(args + ["--kernel", "mxu", "-o", ref]) == 0
    (MP, MPI), (MPr, MPIr) = _files(ours), _files(ref)
    np.testing.assert_array_equal(MPI < 0, MPIr < 0)
    assert_profile_close(T, 24, np.where(MPI >= 0, MP, MPr), MPI, MPr, MPIr, 1e-8)


@pytest.mark.parametrize("left_right", [False, True])
def test_compute_allow_missing_writes_mpxs_files(tmp_path, capsys, left_right):
    T = gapped_series()
    path = _write(tmp_path, "g", T)
    args = ["compute", "-i", path, "-m", "24", "--dtype", "float64", "--band", "64",
            "--chunk", "128"]
    assert port_main(args + ["--device", "cpu"]) == 1  # gaps refused by default
    assert "non-finite" in capsys.readouterr().err
    extra = ["--allow-missing"] + (["--left-right"] if left_right else [])
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + extra + ["-o", ours, "--device", "cpu"]) == 0
    assert mpx_main(args + extra + ["-o", ref]) == 0
    Tf = np.where(np.isfinite(T), T, 0.0)
    for side in ((".left", ".right") if left_right else ("",)):
        (MP, MPI), (MPr, MPIr) = _files(ours + side), _files(ref + side)
        np.testing.assert_array_equal(MPI < 0, MPIr < 0)
        assert_profile_close(Tf, 24, np.where(MPI >= 0, MP, MPr), MPI, MPr, MPIr, 1e-8)


def test_compute_refuses_what_mpx_refuses(tmp_path):
    path = _write(tmp_path, "t", random_walk(300, seed=23))
    base = ["compute", "-i", path, "-m", "16"]
    for extra in (["--left-right", "--checkpoint", "c"],
                  ["--approx", "0.5", "--checkpoint", "c"],
                  ["--approx", "0.5", "--left-right"],
                  ["--allow-missing", "--checkpoint", "c"],
                  ["--allow-missing", "--approx", "0.5"],
                  ["--allow-missing", "--raw"]):
        with pytest.raises(SystemExit):
            port_main(base + extra + ["--device", "cpu"])
        with pytest.raises(SystemExit):
            mpx_main(base + extra)


def test_damp_prints_mpxs_table(tmp_path, capsys):
    path = _write(tmp_path, "a", with_anomaly(m=32))
    args = ["damp", "-i", path, "-m", "32", "--split", "100", "-k", "2", "--dtype", "float64"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + ["-o", ours, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert mpx_main(args + ["-o", ref]) == 0
    exp = capsys.readouterr().out
    assert _table(got) == _table(exp) and len(_table(got)) == 2
    np.testing.assert_allclose(np.load(ours + ".damp.npy"), np.load(ref + ".damp.npy"),
                               atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batch_writes_mpxs_files(tmp_path, capsys, dtype):
    batch = np.cumsum(np.random.default_rng(5).standard_normal((3, 280)), axis=1)
    args = ["batch", "-m", "16", "--dtype", dtype]
    for b in range(3):
        args += ["-i", _write(tmp_path, f"s{b}", batch[b])]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + ["-o", ours, "--device", "cpu"]) == 0
    assert "3 profile pairs" in capsys.readouterr().out
    assert mpx_main(args + ["-o", ref]) == 0
    capsys.readouterr()
    for b in range(3):
        assert_profile_close(batch[b], 16, *_files(f"{ours}.s{b}"), *_files(f"{ref}.s{b}"),
                             EPS[dtype])
    assert port_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("series  min-dist") and len(_table(got)) == 3
    # --shards 2: the series laid over two virtual CPU shards, mpx's files.
    assert port_main(args + ["--shards", "2", "-o", ours + ".sh", "--device", "cpu"]) == 0
    assert mpx_main(args + ["--shards", "2", "-o", ref + ".sh"]) == 0
    capsys.readouterr()
    for b in range(3):
        assert_profile_close(batch[b], 16, *_files(f"{ours}.sh.s{b}"),
                             *_files(f"{ref}.sh.s{b}"), EPS[dtype])


def test_floss_prints_mpxs_boundaries(tmp_path, capsys):
    path = _write(tmp_path, "ts", two_regime_series(n=1200, split=600, seed=7))
    args = ["floss", "-i", path, "-m", "32", "--step", "128", "--dtype", "float64",
            "--window", "700"]
    assert port_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert mpx_main(args) == 0
    exp = capsys.readouterr().out
    assert got.split("window")[1] == exp.split("window")[1]  # after the timing
    assert "regime boundaries" in got
    assert port_main(["floss", "-i", path, "-m", "32", "--step", "0", "--device", "cpu"]) == 1
    assert "--step" in capsys.readouterr().err
    assert port_main(["floss", "-i", path, "-m", "32", "--init", "1200", "--device",
                      "cpu"]) == 1
    assert "whole series" in capsys.readouterr().err
