"""The composition command lines of ``python -m mpx_torch`` (``--device
cpu``) against ``python -m mpx``'s with the same arguments: ``analyze``
(a series with ``--regimes``, ``--chain`` and ``--av complexity``, and
saved ``.mpb``/``.mpib`` results), ``chains``, ``contrast`` (and
``--pan``), ``ostinato``, ``snippets``, ``cluster``, ``motiflets`` (and
``--elbows``) and ``query`` (``i:j`` and ``-o``).  In float64 on series
without ties the printed tables are the same text; written files within
1e-8 (``.cp.npy``) and 1e-10 (``query``'s MASS profile, as
``tests/test_torch_analysis.py`` holds it).
"""

import argparse

import numpy as np
import pytest

from mpx.cli import main as mpx_main
from mpx_torch.cli import (_add_analyze, _add_chains, _add_cluster, _add_contrast,
                           _add_motiflets, _add_ostinato, _add_snippets)
from mpx_torch.cli import main as port_main
from mpx_torch.io.tsb import read_binary, write_binary, write_results
from tests.conftest import random_walk
from tests.test_torch_analysis import assert_mass_close


def _write(tmp_path, name, X):
    path = str(tmp_path / f"{name}.tsb")
    write_binary(path, X, "double")
    return path


def _printed(capsys, main, args):
    """The command's stdout without the logger's ``[INFO] wrote`` lines
    (their paths differ)."""
    capsys.readouterr()
    assert main(args) == 0
    return [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("[")]


def _both(capsys, args, ours_out=None, ref_out=None):
    ours = _printed(capsys, port_main, args + (["-o", ours_out] if ours_out else [])
                    + ["--device", "cpu"])
    ref = _printed(capsys, mpx_main, args + (["-o", ref_out] if ref_out else []))
    return ours, ref


def _walk_with_motif(n=2000, seed=111):
    T = random_walk(n, seed=seed)
    T[1300:1364] = T[1300] - T[400] + T[400:464] + 0.05 * np.sin(np.arange(64))
    return T


@pytest.mark.parametrize("extra", [[], ["--regimes", "2", "--chain", "--av", "complexity"]])
def test_analyze_prints_mpxs_table(tmp_path, capsys, extra):
    path = _write(tmp_path, "t", _walk_with_motif())
    ours, ref = _both(capsys, ["analyze", "-i", path, "-m", "32", "-k", "3",
                               "--dtype", "float64"] + extra)
    assert ours == ref
    assert "motifs (a, b, distance):" in ours and len(ours) >= 8


def test_analyze_reads_saved_results(tmp_path, capsys):
    from mpx.reference import compute_matrix_profile_reference

    T = _walk_with_motif()
    base = str(tmp_path / "saved")
    write_results(base, *compute_matrix_profile_reference(T, 32))
    ours = _printed(capsys, port_main, ["analyze", "-i", base, "-m", "32", "--regimes", "1",
                                        "--device", "cpu"])
    ref = _printed(capsys, mpx_main, ["analyze", "-i", base, "-m", "32", "--regimes", "1"])
    assert ours == ref
    for main in (port_main, mpx_main):
        with pytest.raises(SystemExit, match="--chain needs"):
            main(["analyze", "-i", base, "-m", "32", "--chain"])


@pytest.mark.parametrize("extra", [["--all"], ["--anchor", "500"]])
def test_chains_prints_mpxs_chain(tmp_path, capsys, extra):
    path = _write(tmp_path, "t", random_walk(2000, seed=113))
    ours, ref = _both(capsys, ["chains", "-i", path, "-m", "32", "--dtype", "float64"] + extra)
    assert ours == ref and ours[0].startswith("chain (")


def test_contrast_writes_mpxs_profile(tmp_path, capsys):
    plus, minus = _walk_with_motif(seed=115), random_walk(1500, seed=116)
    p, n = _write(tmp_path, "plus", plus), _write(tmp_path, "minus", minus)
    args = ["contrast", "-p", p, "-n", n, "-m", "32", "-k", "2", "--dtype", "float64",
            "--band", "256", "--chunk", "512"]
    ours_b, ref_b = str(tmp_path / "ours"), str(tmp_path / "ref")
    ours, ref = _both(capsys, args, ours_b, ref_b)
    assert ours == ref and len(ours) == 2
    np.testing.assert_allclose(np.load(ours_b + ".cp.npy"), np.load(ref_b + ".cp.npy"),
                               rtol=0, atol=1e-8)
    pan = ["contrast", "-p", p, "-n", n, "--pan", "24,32", "--dtype", "float64",
           "--band", "256", "--chunk", "512"]
    ours, ref = _both(capsys, pan, ours_b, ref_b)
    assert ours == ref
    got, exp = np.load(ours_b + ".pancp.npz"), np.load(ref_b + ".pancp.npz")
    assert sorted(got.files) == sorted(exp.files) == ["m24", "m32"]
    for key in got.files:
        np.testing.assert_allclose(got[key], exp[key], rtol=0, atol=1e-8)
    capsys.readouterr()
    assert port_main(["contrast", "-p", p, "-n", n, "--device", "cpu"]) == 1


def test_ostinato_prints_mpxs_motif(tmp_path, capsys):
    rng = np.random.default_rng(117)
    shape = np.cumsum(rng.standard_normal(64))
    paths = []
    for i, n in enumerate((900, 1100, 1000)):
        T = random_walk(n, seed=118 + i)
        T[200 + 100 * i : 264 + 100 * i] = shape + 0.05 * rng.standard_normal(64)
        paths.append(_write(tmp_path, f"s{i}", T))
    args = ["ostinato", "-m", "32", "--dtype", "float64"]
    for p in paths:
        args += ["-i", p]
    ours, ref = _both(capsys, args)
    assert ours == ref and ours[0].startswith("consensus motif: series")


def test_snippets_prints_mpxs_table(tmp_path, capsys):
    t = np.arange(2400)
    T = np.where(t < 1200, np.sin(t / 8.0), np.sign(np.sin(t / 13.0)))
    T = T + 0.05 * np.random.default_rng(121).standard_normal(2400)
    path = _write(tmp_path, "t", T)
    ours, ref = _both(capsys, ["snippets", "-i", path, "-L", "200", "-k", "2",
                               "--dtype", "float64"])
    assert ours == ref and len(ours) == 3


def test_cluster_prints_mpxs_table(tmp_path, capsys):
    rng = np.random.default_rng(123)
    bases = [random_walk(1200, seed=124), random_walk(1200, seed=125)]
    args = ["cluster", "-m", "32", "-k", "2", "--threshold", "0.1", "--dtype", "float64"]
    for i in range(4):
        T = random_walk(700, seed=126 + i)
        b = bases[i % 2]
        T[100:400] = T[100] - b[300] + b[300:600] + 0.05 * rng.standard_normal(300)
        args += ["-i", _write(tmp_path, f"s{i}", T)]
    ours, ref = _both(capsys, args)
    assert ours == ref and sum(ln.startswith("cluster ") for ln in ours) == 2


@pytest.mark.parametrize("extra", [["-k", "3"], ["--elbows", "4"]])
def test_motiflets_prints_mpxs_sets(tmp_path, capsys, extra):
    rng = np.random.default_rng(131)
    T = random_walk(2500, seed=132)
    shape = 4 * np.sin(np.linspace(0, 4 * np.pi, 48))
    for at in (300, 1100, 1900):
        T[at : at + 48] = T[at] + shape + 0.1 * rng.standard_normal(48)
    path = _write(tmp_path, "t", T)
    ours, ref = _both(capsys, ["motiflets", "-i", path, "-m", "32", "--candidates", "16",
                               "--dtype", "float64"] + extra)
    assert ours == ref
    capsys.readouterr()
    assert port_main(["motiflets", "-i", path, "-m", "32", "--device", "cpu"]) == 1


@pytest.mark.parametrize("query", ["400:464", "file"])
def test_query_matches_mpxs(tmp_path, capsys, query):
    T = _walk_with_motif()
    path = _write(tmp_path, "t", T)
    if query == "file":
        query = _write(tmp_path, "q", T[1300:1364])
    args = ["query", "-i", path, "-q", query, "-k", "3"]
    ours_b, ref_b = str(tmp_path / "ours"), str(tmp_path / "ref")
    ours = _printed(capsys, port_main, args + ["-o", ours_b])
    ref = _printed(capsys, mpx_main, args + ["-o", ref_b])
    assert ours == ref and len(ours) >= 2
    assert_mass_close(read_binary(ours_b + ".mpb", "double"),
                      read_binary(ref_b + ".mpb", "double"))


@pytest.mark.parametrize("command", ["analyze", "chains", "contrast", "ostinato", "snippets",
                                     "cluster", "motiflets"])
def test_composition_commands_default_to_the_card(command):
    """The compositions that reach a tier run on ``cuda`` unless asked for
    the CPU (``query`` is host MASS, as in mpx)."""
    sub = argparse.ArgumentParser().add_subparsers()
    add = {"analyze": _add_analyze, "chains": _add_chains, "contrast": _add_contrast,
           "ostinato": _add_ostinato, "snippets": _add_snippets, "cluster": _add_cluster,
           "motiflets": _add_motiflets}[command]
    req = {"contrast": ["-p", "x", "-n", "y"], "snippets": ["-i", "x", "-L", "64"],
           "ostinato": ["-i", "x", "-i", "y", "-m", "8"],
           "cluster": ["-i", "x", "-i", "y", "-m", "8"]}.get(command, ["-i", "x", "-m", "8"])
    assert add(sub).parse_args(req).device == "cuda"
