"""mpx_torch's ``io/`` and its ``tsbin``, ``golden`` and ``datasets``
subcommands against mpx's: the same files byte for byte and the same
listings."""

import os

import numpy as np
import pytest

from mpx.cli import main as mpx_main
from mpx.io import datasets as mpx_datasets
from mpx.io.tsb import write_ascii as mpx_write_ascii
from mpx_torch.cli import main as port_main
from mpx_torch.io import datasets
from mpx_torch.io.tsb import read_series, write_ascii
from tests.conftest import DATA_DIR


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("oneline", [False, True])
def test_write_ascii_matches_mpx(tmp_path, oneline):
    x = np.concatenate([np.random.default_rng(0).standard_normal(200) * 1e3,
                        [0.0, -0.0, 1e-300, 123456789.125, np.pi]])
    write_ascii(str(tmp_path / "ours.txt"), x, oneline=oneline)
    mpx_write_ascii(str(tmp_path / "ref.txt"), x, oneline=oneline)
    assert _bytes(tmp_path / "ours.txt") == _bytes(tmp_path / "ref.txt")
    np.testing.assert_array_equal(read_series(str(tmp_path / "ours.txt")), x)


@pytest.mark.parametrize("kind", ["double", "int", "ap16", "ap24", "ap32", "ap64"])
def test_tsbin_round_trip_matches_mpx(tmp_path, capsys, kind):
    """``tsbin -e`` then ``tsbin -d`` (to a file, with -l/--offset, and to
    stdout) write mpx's bytes and print mpx's lines."""
    src = os.path.join(DATA_DIR, "test", "1024.txt")
    files = {}
    for tool, main in (("ours", port_main), ("ref", mpx_main)):
        enc, dec = str(tmp_path / f"{tool}.bin"), str(tmp_path / f"{tool}.txt")
        assert main(["tsbin", "-e", src, "-o", enc, "-t", kind, "-n", "1024"]) == 0
        assert main(["tsbin", "-d", enc, "-o", dec, "-t", kind, "-l", "100",
                     "--offset", "7", "--oneline"]) == 0
        capsys.readouterr()
        assert main(["tsbin", "-d", enc, "-t", kind, "-l", "5"]) == 0
        files[tool] = (_bytes(enc), _bytes(dec), capsys.readouterr().out.splitlines()[-5:])
    assert files["ours"] == files["ref"]


def test_tsbin_rejects_what_mpx_rejects(tmp_path):
    src = os.path.join(DATA_DIR, "test", "1024.txt")
    out = str(tmp_path / "x.tsb")
    for args in (["-e", src], ["-e", src, "-o", out, "-n", "5"],
                 ["-d", src, "-l", "-1"], ["-d", src, "--offset", "-2"]):
        with pytest.raises(SystemExit):
            port_main(["tsbin", *args])


def test_golden_matches_mpx(tmp_path):
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert port_main(["golden", "-i", inp, "-o", ours, "-m", "32"]) == 0
    assert mpx_main(["golden", "-i", inp, "-o", ref, "-m", "32"]) == 0
    for ext in (".mpb", ".mpib"):
        assert _bytes(ours + ext) == _bytes(ref + ext)


def test_datasets_listing_matches_mpx(capsys):
    assert datasets.list_datasets() == mpx_datasets.list_datasets()
    assert datasets.list_datasets("test") == mpx_datasets.list_datasets("test")
    assert datasets.listings() == mpx_datasets.listings()
    assert port_main(["datasets"]) == 0
    ours = capsys.readouterr().out
    assert mpx_main(["datasets"]) == 0
    assert ours == capsys.readouterr().out and "binary:\n  1024.tsb" in ours


@pytest.mark.parametrize("name,category", [("1024.txt", None), ("test/1024.txt", None),
                                           ("16384.tsb", "binary")])
def test_load_dataset_matches_mpx(name, category):
    path = datasets.dataset_path(name, category)
    assert path == mpx_datasets.dataset_path(name, category)
    np.testing.assert_array_equal(datasets.load_dataset(name, category),
                                  mpx_datasets.load_dataset(name, category))


def test_missing_dataset_and_random_walk():
    with pytest.raises(FileNotFoundError):
        datasets.dataset_path("nope.txt")
    np.testing.assert_array_equal(datasets.generate_random_walk(1000, seed=4),
                                  mpx_datasets.generate_random_walk(1000, seed=4))
