"""The harness on the CPU: each cell rehearsed end to end in a fresh
process that loads neither JAX nor mpx, the command's refusals, and a cell
added by new files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import files, harness
from portbench.tests.tiny import TINY, rehearse

ROOT = files.ROOT
CELLS = sorted(TINY)


def _python(code: str, cwd=ROOT, env=None, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_rehearses_in_a_fresh_process_without_jax_or_mpx(workload, trace):
    code = (
        "import json, sys\n"
        "from portbench.tests.tiny import rehearse\n"
        f"r = rehearse({workload!r}, trace={bool(trace)})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mpx'))\n"
        "print(json.dumps({'bad': bad, 'result': r}))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    r = out["result"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["dist_err"]["value"] <= 1e-8
    bench = files.benchmark(ROOT)
    want = {m["name"] for m in harness.metric_entries(bench, workload, bool(trace))}
    got = set(r["metrics"])
    if trace:
        # On the CPU nothing runs on a device, so no per-layer metric
        # finds anything to read.
        assert want and got == set()
    else:
        assert got == want and "setup_s" in got


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys, numpy as np\n"
        "from portbench import check, files\n"
        "ref = files.module(files.ROOT, 'reference', 'exact_rows')\n"
        "T = np.cumsum(np.random.default_rng(0).standard_normal(200))\n"
        "ref.exact_rows(T, 16, np.arange(10))\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('mpx_torch', 'mpx', 'jax', 'jaxlib', 'flax')))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_command_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                           "showcase-f64.selfjoin", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_command_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                           "showcase-f64.selfjoin", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_cell_and_a_metric_added_as_files_run_without_editing_any(tmp_path):
    """A new configuration, traffic mix and metric, and a ``workloads`` entry
    naming them: the harness finds them all by name."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "mpx_torch"), tmp_path / "mpx_torch")
    before = {p: open(p, "rb").read() for p in _files(tmp_path / "portbench")}
    bench = files.benchmark(ROOT)
    new = tmp_path / "portbench"
    (new / "configs" / "walk-f32-small.json").write_text(json.dumps({
        "name": "walk-f32-small", "m": 16, "dtype": "float32", "tolerance": 2e-3,
        "data": {"kind": "random_walk", "length": 900}, "reference": "exact_rows"}))
    (new / "traffic" / "sampled.json").write_text(json.dumps({
        "loop": "selfjoin", "warmup": 1, "check": {"share": 0.5, "rows": 64}}))
    (new / "metrics" / "job_median_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    d = [(r.t1 - r.t0) * 1e3 for r in run.of('selfjoin')]\n"
        "    return float(np.median(d)) if d else None\n")
    bench["configs"].append({"name": "walk-f32-small", "source": "https://example.org/walk",
                             "file": "portbench/configs/walk-f32-small.json", "reduced": [],
                             "why": "a test's cell"})
    bench["workloads"].append({"name": "walk-f32-small.sampled", "config": "walk-f32-small",
                               "traffic": "sampled", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "job_median_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["walk-f32-small.sampled"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = rehearse("walk-f32-small.sampled", root=str(tmp_path), overrides={})
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"job_median_ms", "setup_s"}
    assert r["metrics"]["job_median_ms"]["value"] > 0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _files(d):
    return [os.path.join(a, f) for a, _, fs in os.walk(d) for f in fs
            if "__pycache__" not in a]
