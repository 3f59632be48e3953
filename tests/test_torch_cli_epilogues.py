"""The ``abjoin``, ``topk``, ``thresh``, ``compute --raw``, ``matrix``,
``mstamp``, ``pan`` and ``merlin`` subcommands of ``python -m mpx_torch`` (``--device cpu``) against ``python
-m mpx``'s with the same arguments: the same files, distances within 1e-8
(float64) / 2e-3 (float32; the pooled matrix, whose tiles are float32),
indices equal but between equidistant neighbors, counts equal (float64) or
apart only by pairs within 1e-5 of the threshold (float32).
"""

import argparse

import numpy as np
import pytest

from mpx.cli import main as mpx_main
from mpx_torch.abjoin import unit_windows
from mpx_torch.cli import (_add_abjoin, _add_matrix, _add_merlin, _add_mstamp, _add_pan,
                           _add_thresh, _add_topk)
from mpx_torch.cli import main as port_main
from mpx_torch.io.tsb import read_binary, write_binary
from tests.conftest import random_walk
from tests.test_torch_abjoin import assert_ab_close
from tests.test_torch_thresh import _near_counts, assert_thresh_close
from tests.test_torch_topk import assert_topk_close

EPS = {"float32": 2e-3, "float64": 1e-8}


def _series(tmp_path, name, n, seed):
    X = random_walk(n, seed=seed)
    path = str(tmp_path / f"{name}.tsb")
    write_binary(path, X, "double")
    return X, path


def _both(tmp_path, args):
    """Run the port (on the CPU) and mpx with the same arguments; returns
    the two output base paths."""
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(args + ["-o", ours, "--device", "cpu"]) == 0
    assert mpx_main(args + ["-o", ref]) == 0
    return ours, ref


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_abjoin_writes_mpxs_files(tmp_path, dtype):
    (A, a), (B, b) = _series(tmp_path, "a", 700, 1), _series(tmp_path, "b", 500, 2)
    m = 16
    ours, ref = _both(tmp_path, ["abjoin", "-a", a, "-b", b, "-m", str(m), "--dtype", dtype,
                                 "--band", "128", "--chunk", "256"])
    files = [[read_binary(base + side + ext, kind) for side in (".a", ".b")
              for ext, kind in ((".mpb", "double"), (".mpib", "int"))] for base in (ours, ref)]
    assert files[0][0].shape == (700 - m + 1,) and files[0][2].shape == (500 - m + 1,)
    assert_ab_close(A, B, m, *files, EPS[dtype])


def test_topk_writes_mpxs_file(tmp_path):
    T, path = _series(tmp_path, "t", 900, 3)
    m = 16
    ours, ref = _both(tmp_path, ["topk", "-i", path, "-m", str(m), "-k", "3", "--dtype",
                                 "float64", "--band", "128", "--chunk", "256"])
    got, exp = np.load(ours + ".topk.npz"), np.load(ref + ".topk.npz")
    assert got["distances"].shape == (900 - m + 1, 3)
    Z = unit_windows(T, m)
    assert_topk_close(Z, Z, m, got["distances"], got["indices"], exp["distances"],
                      exp["indices"], EPS["float64"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thresh_writes_mpxs_file(tmp_path, dtype, capsys):
    T, path = _series(tmp_path, "t", 800, 4)
    m, thr = 16, 0.6
    ours, ref = _both(tmp_path, ["thresh", "-i", path, "-m", str(m), "--threshold", str(thr),
                                 "--dtype", dtype, "--band", "128", "--chunk", "256"])
    assert "densest windows" in capsys.readouterr().out
    got, exp = np.load(ours + ".thresh.npz"), np.load(ref + ".thresh.npz")
    Z = unit_windows(T, m)
    i = np.arange(Z.shape[0])
    near = _near_counts(Z, Z, np.abs(i[:, None] - i[None, :]) >= m // 4, thr)
    assert_thresh_close(got["sums"], got["counts"], exp["sums"], exp["counts"], dtype, near)


def test_abjoin_mpdist_is_not_ported(tmp_path, capsys):
    """Once refused; now ``abjoin --mpdist`` prints mpx's line, the value
    within 1e-8 of mpx's (float64)."""
    (_, a), (_, b) = _series(tmp_path, "a", 300, 5), _series(tmp_path, "b", 300, 6)
    args = ["abjoin", "-a", a, "-b", b, "-m", "16", "--mpdist", "--dtype", "float64"]
    capsys.readouterr()
    assert port_main(args + ["--device", "cpu"]) == 0
    ours = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("MPdist: ")]
    assert mpx_main(args) == 0
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("MPdist: ")]
    assert len(ours) == len(ref) == 1
    assert abs(float(ours[0].split()[1]) - float(ref[0].split()[1])) <= EPS["float64"]


@pytest.mark.parametrize("command", ["abjoin", "topk", "thresh", "matrix", "mstamp", "pan",
                                     "merlin"])
def test_epilogue_commands_default_to_the_card(command):
    """Like ``compute``, the new subcommands run on ``cuda`` unless asked
    for the CPU."""
    sub = argparse.ArgumentParser().add_subparsers()
    add = {"abjoin": _add_abjoin, "topk": _add_topk, "thresh": _add_thresh,
           "matrix": _add_matrix, "mstamp": _add_mstamp, "pan": _add_pan,
           "merlin": _add_merlin}[command]
    p = add(sub)
    req = {"abjoin": ["-a", "x", "-b", "y"], "pan": ["-i", "x", "--m-lo", "8", "--m-hi", "16"],
           "merlin": ["-i", "x", "--lo", "8", "--hi", "16"]}.get(command, ["-i", "x", "-m", "8"])
    assert p.parse_args(req).device == "cuda"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compute_raw_writes_mpxs_files(tmp_path, dtype):
    """``compute --raw``: the raw-Euclidean profile, mpx's files within its
    AAMP tolerance (2e-4 / 1e-10 of the largest distance)."""
    from tests.test_torch_aamp import RTOL, assert_raw_close

    T, path = _series(tmp_path, "t", 500, 7)
    m = 24
    ours, ref = _both(tmp_path, ["compute", "-i", path, "-m", str(m), "--raw", "--dtype",
                                 dtype, "--band", "32", "--chunk", "64"])
    D, I, eD, eI = (read_binary(base + ext, kind) for base in (ours, ref)
                    for ext, kind in ((".mpb", "double"), (".mpib", "int")))
    assert D.shape == (500 - m + 1,)
    assert_raw_close(T, m, D, I.astype(np.int32), eD, eI, RTOL[dtype] * eD.max())


def test_compute_raw_refuses_what_mpx_refuses(tmp_path):
    """mpx's ``--raw`` is a single-device full-profile mode: with
    ``--left-right``, ``--checkpoint``, ``--shards`` or ``--approx`` both
    exit with mpx's refusal."""
    _, path = _series(tmp_path, "t", 300, 8)
    base = ["compute", "-i", path, "-m", "16", "--raw", "--device", "cpu"]
    for extra in (["--left-right"], ["--checkpoint", "c"], ["--shards", "2"],
                  ["--approx", "0.5"]):
        with pytest.raises(SystemExit):
            port_main(base + extra)
        with pytest.raises(SystemExit):
            mpx_main(base[:-2] + extra)


@pytest.mark.parametrize("with_b", [False, True])
def test_matrix_writes_mpxs_file(tmp_path, capsys, with_b):
    """``matrix``, the self-join and with ``-b`` the AB-join: ``<o>.dm.npy``
    within 2e-3 of mpx's, and the best cell printed."""
    _, path = _series(tmp_path, "t", 700, 9)
    args = ["matrix", "-i", path, "-m", "24", "--mwidth", "9", "--mheight", "11",
            "--band", "128", "--chunk", "128"]
    if with_b:
        args += ["-b", _series(tmp_path, "b", 500, 10)[1], "--pearson"]
    ours, ref = _both(tmp_path, args)
    assert "best cell" in capsys.readouterr().out
    got, exp = np.load(ours + ".dm.npy"), np.load(ref + ".dm.npy")
    assert got.shape == exp.shape == (11, 9) and got.dtype == np.float64
    np.testing.assert_allclose(got, exp, rtol=0, atol=EPS["float32"])


@pytest.mark.parametrize("extra", [[], ["--include", "1", "--mdl"], ["--discords"]])
def test_mstamp_writes_mpxs_file(tmp_path, capsys, extra):
    """``mstamp``: ``<o>.mstamp.npz`` within 1e-8 of mpx's, the same table."""
    (X, a), (Y, b), (Z, c) = (_series(tmp_path, f"d{t}", 300, 11 + t) for t in range(3))
    args = ["mstamp", "-i", a, "-i", b, "-i", c, "-m", "16", "--dtype", "float64"] + extra
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    tables = []
    for main, base, dev in ((port_main, ours, ["--device", "cpu"]), (mpx_main, ref, [])):
        assert main(args + ["-o", base] + dev) == 0
        tables.append([ln for ln in capsys.readouterr().out.splitlines()
                       if not ln.startswith("[INFO]")])
    assert tables[0] == tables[1]
    assert ("MDL: best k" in tables[0][-1]) == ("--mdl" in extra)
    got, exp = np.load(ours + ".mstamp.npz"), np.load(ref + ".mstamp.npz")
    assert got["PMP"].shape == (3, 300 - 16 + 1)
    np.testing.assert_allclose(got["PMP"], exp["PMP"], rtol=0, atol=EPS["float64"])
    np.testing.assert_array_equal(got["PMPI"], exp["PMPI"])


def test_mstamp_refuses_unequal_lengths(tmp_path):
    (_, a), (_, b) = _series(tmp_path, "a", 300, 14), _series(tmp_path, "b", 200, 15)
    assert port_main(["mstamp", "-i", a, "-i", b, "-m", "16", "--device", "cpu"]) == 1


@pytest.mark.parametrize("method,dtype", [("fused", "float32"), ("exact", "float64")])
def test_pan_writes_mpxs_file(tmp_path, capsys, method, dtype):
    """``pan``: ``<o>.pan.npz`` within mpx's tolerance of mpx's file, and the
    same motif and discord tables."""
    _, path = _series(tmp_path, "t", 600, 16)
    args = ["pan", "-i", path, "--m-lo", "8", "--m-hi", "32", "--count", "3", "--method",
            method, "--dtype", dtype, "--motifs", "2", "--discords", "2"]
    ours, ref = _both(tmp_path, args)
    out = capsys.readouterr().out
    assert out.count("variable-length motifs") == 2 and out.count("variable-length discords") == 2
    got, exp = np.load(ours + ".pan.npz"), np.load(ref + ".pan.npz")
    np.testing.assert_array_equal(got["ms"], exp["ms"])
    fin = np.isfinite(exp["PMP"])
    np.testing.assert_array_equal(np.isfinite(got["PMP"]), fin)
    np.testing.assert_allclose(got["PMP"][fin], exp["PMP"][fin], rtol=0, atol=EPS[dtype])
    assert port_main(args[:9] + ["--device", "cpu"]) == 0
    assert "min(normalized distance)" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--motifs"]])
def test_merlin_prints_mpxs_table(tmp_path, capsys, extra):
    """``merlin``: the exact per-length extrema, printed as mpx prints them
    (equal to the printed digits)."""
    _, path = _series(tmp_path, "t", 700, 17)
    args = ["merlin", "-i", path, "--lo", "8", "--hi", "12", "-k", "2"] + extra
    assert port_main(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert mpx_main(args) == 0
    assert ours == capsys.readouterr().out
    assert "exact " + ("motifs" if extra else "discords") + " at 5 lengths" in ours
