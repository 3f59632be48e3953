"""The one-line benchmark contract in mpx_torch (``python -m
mpx_torch.bench_line``) against the root ``bench.py`` on the CPU: the
root script's showcase job, one JSON line with its keys and its
``vs_baseline``, and the showcase profile at n = 4096 against mpx's on the
same series within 1e-8 (float64).
"""

import json
import subprocess
import sys

import numpy as np

import bench as root_bench
from mpx.bench import BASELINE_PAIRS_PER_SEC
from mpx.config import MatrixProfileConfig as MpxConfig
from mpx.driver import compute_matrix_profile as mpx_compute
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch import bench_line
from tests.conftest import REPO_ROOT
from tests.helpers import assert_profile_close

N = 4096
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _showcase_args() -> dict:
    """The root script's SHOWCASE flags as a dict."""
    flags = root_bench.SHOWCASE
    return {flags[i].lstrip("-"): flags[i + 1] for i in range(0, len(flags), 2)}


def test_showcase_is_the_root_scripts():
    args = _showcase_args()
    assert bench_line.SHOWCASE == {k: int(args[k]) if k != "dtype" else args[k]
                                   for k in ("n", "m", "dtype", "band", "chunk")}


def test_one_json_line_with_the_root_scripts_keys(capsys):
    assert bench_line.main(["-n", str(N), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert KEYS <= set(line)
    assert line["metric"] == f"self-join distance-pairs/sec (n={N}, m=256, double)"
    assert line["unit"] == "pairs/s" and line["value"] > 0
    # computed as the root script computes it (mpx/bench.py's main)
    assert line["vs_baseline"] == line["value"] / BASELINE_PAIRS_PER_SEC
    assert (line["device"], line["power_limit"]) == ("cpu", None)
    assert line["baseline_published"] == json.load(open(bench_line.BASELINE_JSON))["published"]


def test_module_runs_as_a_script():
    proc = subprocess.run([sys.executable, "-m", "mpx_torch.bench_line", "-n", "2048",
                           "--device", "cpu"], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1 and KEYS <= set(json.loads(lines[0]))


def test_showcase_profile_matches_mpx():
    """The line's job (the showcase config, ``auto``, the benchmark's seed-0
    walk) at n = 4096: the port's profile against mpx's within 1e-8."""
    job = dict(bench_line.SHOWCASE)
    del job["n"]
    T = np.cumsum(np.random.default_rng(0).standard_normal(N))
    MP, MPI = (x.numpy() for x in compute_matrix_profile(
        T, config=MatrixProfileConfig(**job, kernel="auto", device="cpu")))
    mMP, mMPI = (np.asarray(x) for x in mpx_compute(T, config=MpxConfig(**job, kernel="auto")))
    assert MP.dtype == np.float64
    assert_profile_close(T, 256, MP, MPI, mMP, mMPI, eps=1e-8)
