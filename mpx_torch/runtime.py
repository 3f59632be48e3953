"""Device runtime layer, counterpart of ``mpx/runtime.py``.

The analog of the reference's OpenCL wrapper (include/host/OpenCL.hpp):
where that wraps device discovery, buffer placement, program loading and
queue synchronization, the CUDA equivalents are

* device discovery            -> :func:`devices` / :class:`DeviceContext`
* ``Buffer::CopyFromHost``    -> :meth:`DeviceContext.to_device`
* ``Buffer::CopyToHost``      -> :meth:`DeviceContext.to_host`
* xclbin ``Program``          -> the kernel library built by nvcc into the
                                 build directory (:func:`enable_compilation_cache`,
                                 ``mpx_torch/kernels/_build.py``)
* ``Context::Finish`` (ns)    -> :meth:`DeviceContext.finish`
* compute-unit addressing     -> the mesh in :mod:`mpx_torch.parallel.mesh`

There is no buffer-bank management: PyTorch's caching allocator owns the
card's memory.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from mpx_torch.utils.logging import Logger

_CACHE_ENABLED = False


def enable_compilation_cache(path: Optional[str] = None):
    """Keep the built kernel library across processes (the analog of
    shipping a prebuilt xclbin instead of re-synthesizing): point the build
    directory of ``mpx_torch/kernels/_build.py`` at ``path`` (default: the
    package's ``_build/``).  A library built there for the current sources
    is loaded as it is; nothing is compiled here.  Safe to call
    repeatedly."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    from mpx_torch.kernels import _build

    path = path or _build.BUILD_DIR
    try:
        os.makedirs(path, exist_ok=True)
        _build.BUILD_DIR = path
        _CACHE_ENABLED = True
        Logger.verbose_log(f"kernel build directory at {path}")
    except OSError as e:  # the cache is best-effort
        Logger.warning(f"kernel build directory unavailable: {e}")


def devices(platform: Optional[str] = None):
    """The cards as ``torch.device``s, or ``[cpu]`` when asked for the CPU
    (``platform="cpu"``)."""
    if platform == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceContext:
    """Thin staging/synchronization helper around one device."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._pending = []

    def to_device(self, array, dtype=None):
        arr = np.asarray(array, dtype=dtype) if dtype else np.asarray(array)
        out = torch.as_tensor(arr, device=self.device)
        self._pending.append(out)
        return out

    @staticmethod
    def to_host(array) -> np.ndarray:
        if isinstance(array, torch.Tensor):
            return array.cpu().numpy()
        return np.asarray(array)

    def finish(self, *values) -> int:
        """Block until the device has finished the work queued so far (the
        tracked and the passed values included); returns elapsed
        nanoseconds (Context::Finish analog, OpenCL.hpp:85-89)."""
        del values  # one synchronize covers every queued value
        t0 = time.perf_counter_ns()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._pending.clear()
        return time.perf_counter_ns() - t0

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def memory_stats(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return dict(torch.cuda.memory_stats(self.device))
