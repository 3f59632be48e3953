"""mpx_torch stands alone: no JAX, no mpx, no silent fallbacks."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpx_torch import MatrixProfileConfig
from mpx_torch.io.tsb import read_series
from tests.conftest import REPO_ROOT

PKG = os.path.join(REPO_ROOT, "mpx_torch")


def test_fresh_process_imports_neither_jax_nor_mpx():
    code = (
        "import sys, numpy as np\n"
        "import mpx_torch\n"
        "T = np.cumsum(np.random.default_rng(0).standard_normal(300))\n"
        "MP, MPI = mpx_torch.matrix_profile(T, 16, band=64, chunk=64, device='cpu')\n"
        "assert MP.shape == (285,) and (MPI >= 0).all()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'mpx'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_package_imports_jax_or_mpx():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
               for f in fs if f.endswith(".py")]
    sources.append(os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert len(sources) > 15
    for path in sources:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mpx"), (path, mod)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatrixProfileConfig(m=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatrixProfileConfig(m=16, device="cuda:0")
    assert MatrixProfileConfig(m=16, device="cpu").device == "cpu"


@pytest.mark.parametrize("kwargs,item", [
    (dict(dispatch_group=64), "Not to port"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        MatrixProfileConfig(m=16, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(num_shards=2), dict(shard_mode="ring")])
def test_sharding_options_are_accepted(kwargs):
    """Multi-device sharding, once refused, is ported (mpx_torch.parallel):
    the configs are accepted as mpx's are."""
    cfg = MatrixProfileConfig(m=16, device="cpu", **kwargs)
    assert (cfg.num_shards, cfg.shard_mode) == (kwargs.get("num_shards"),
                                                kwargs.get("shard_mode", "jobs"))


@pytest.mark.parametrize("kwargs,eps", [
    (dict(input_quant="ap16"), 2e-3),
    (dict(dtype="ap32"), 1e-8),
])
def test_fixed_point_options_run_and_agree_with_mpx(kwargs, eps):
    """The fixed-point input tier, once refused, runs and gives mpx's
    profile of the quantized series (float32 tolerance for ap16, float64
    for ap32)."""
    import mpx
    from mpx.io.apfixed import quantize

    from mpx_torch import compute_matrix_profile
    from tests.helpers import assert_profile_close

    T = read_series(os.path.join(REPO_ROOT, "data", "test", "1024.txt"))
    cfg = MatrixProfileConfig(m=16, device="cpu", band=256, chunk=512, **kwargs)
    MP, MPI = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    MP_ref, MPI_ref = mpx.compute_matrix_profile(
        T, config=mpx.MatrixProfileConfig(m=16, band=256, chunk=512, **kwargs))
    Tq = quantize(T, cfg.input_quant)
    assert_profile_close(Tq, 16, MP, MPI, np.asarray(MP_ref), np.asarray(MPI_ref), eps=eps)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_recurrence_kernels_are_accepted(kernel):
    assert MatrixProfileConfig(m=16, device="cpu", kernel=kernel).kernel == kernel


@pytest.mark.parametrize("kwargs", [
    dict(kernel="fused"), dict(dtype="bfloat16"), dict(m=3), dict(band=0),
    dict(shard_mode="mesh"), dict(band=12, tile_rows=8),
])
def test_invalid_options_raise(kwargs):
    with pytest.raises(ValueError):
        MatrixProfileConfig(**{"m": 16, "device": "cpu", **kwargs})


def test_quantized_container_is_not_read_as_doubles(tmp_path):
    """An MPXQ container, whatever its extension, is read as its quantized
    values (as mpx reads it), not as raw doubles."""
    from mpx.io.apfixed import write_quantized
    from mpx.io.tsb import read_series as mpx_read_series

    T = np.random.default_rng(3).uniform(-7, 7, 100)
    path = str(tmp_path / "q.tsb")
    write_quantized(path, T, "ap24")
    got = read_series(path)
    np.testing.assert_array_equal(got, mpx_read_series(path))
    np.testing.assert_array_equal(got, np.trunc(T * 2**16) / 2**16)


def test_kernel_library_is_not_built_at_import():
    from mpx_torch.kernels import _build

    assert _build._LIB is None
    so = _build.library_path()
    assert so.startswith(os.path.join(PKG, "_build"))
    assert os.path.basename(so).startswith("libmpx_torch_")


def test_validate_series():
    cfg = MatrixProfileConfig(m=16, device="cpu")
    with pytest.raises(ValueError):
        cfg.validate_series(10)
    T = np.ones(100)
    T[40] = np.nan
    with pytest.raises(ValueError, match="index 40"):
        cfg.validate_series(100, T)
