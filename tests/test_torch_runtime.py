"""mpx_torch's device runtime layer (``mpx_torch/runtime.py``) on the CPU,
beside mpx's (``mpx/runtime.py``), and the ``--version`` banner."""

import os

import numpy as np
import pytest
import torch

from mpx.runtime import DeviceContext as MpxDeviceContext
from mpx_torch import runtime
from mpx_torch.runtime import DeviceContext, devices


@pytest.mark.parametrize("dtype", [None, np.float64, np.int32])
def test_device_context_roundtrip_equals_mpxs(dtype):
    x = np.arange(16, dtype=np.float32) * 0.5
    ctx, ref = DeviceContext(device="cpu"), MpxDeviceContext()
    d = ctx.to_device(x, dtype=dtype)
    assert isinstance(d, torch.Tensor) and d.device.type == "cpu"
    assert len(ctx._pending) == 1
    ns = ctx.finish(d)
    assert isinstance(ns, int) and ns >= 0 and ctx._pending == []
    got, want = ctx.to_host(d), ref.to_host(ref.to_device(x, dtype=dtype))
    # torch keeps float64 where JAX without x64 stores float32
    assert got.dtype == np.dtype(dtype or np.float32)
    np.testing.assert_array_equal(got, want)


def test_platform_devices_and_memory_stats_off_the_card():
    ctx = DeviceContext(device="cpu")
    assert ctx.platform == "cpu" and ctx.memory_stats() == {}
    assert devices("cpu") == [torch.device("cpu")]
    assert devices() == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    # to_host takes tensors and array-likes alike
    np.testing.assert_array_equal(DeviceContext.to_host([1, 2]), [1, 2])


def test_enable_compilation_cache_points_the_build_directory(tmp_path, monkeypatch):
    """The port's persistent cache is the kernel build directory; enabling
    it builds nothing, and a second call changes nothing."""
    from mpx_torch.kernels import _build

    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    path = str(tmp_path / "kernels")
    runtime.enable_compilation_cache(path)
    assert _build.BUILD_DIR == path and runtime._CACHE_ENABLED
    assert _build.library_path().startswith(path)
    runtime.enable_compilation_cache(str(tmp_path / "other"))
    assert _build.BUILD_DIR == path
    assert _build._LIB is None and not list((tmp_path / "kernels").iterdir())


@pytest.mark.parametrize("flag", ["--version", "-v"])
def test_version_banner(flag, capsys):
    """``python -m mpx_torch --version``: the versions, the device,
    whether the kernel library for the current sources is built, whether
    the native host library loads, and the statistics backend ``auto``
    takes here."""
    import mpx_torch
    from mpx_torch.cli import main
    from mpx_torch.kernels import _build

    assert main([flag]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"mpx_torch {mpx_torch.__version__}"
    assert lines[1] == f"  torch {torch.__version__} (CUDA build: {torch.version.cuda or 'none'})"
    if not torch.cuda.is_available():
        assert lines[2] == "  device: cpu (no CUDA device)"
    built = os.path.exists(_build.library_path())
    assert lines[3].startswith(f"  kernel library (K1, K3, stats): "
                               f"{'built' if built else 'not built'} (")
    assert os.path.basename(_build.library_path()) in lines[3]
    assert lines[4] == "  native host library: built"
    assert lines[5] == ("  statistics backend (auto): "
                        f"{'device' if torch.cuda.is_available() else 'numpy'}")
