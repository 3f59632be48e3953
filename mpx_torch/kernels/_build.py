"""Build and load the CUDA kernels of ``mpx_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one process for
each source, all started together, and linked into one shared library with
a plain C interface, at first use, into ``mpx_torch/_build/``
(listed in .gitignore), and loaded with ``ctypes``.  The library's name
carries a hash of the sources and flags, so an edited source rebuilds.
Nothing is built at import time, and a failed build raises with nvcc's
output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
#: nvcc's output of the build this process made (ptxas register and
#: shared-memory report per kernel); None when the library was already built.
BUILD_LOG: str | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libmpx_torch_{h.hexdigest()[:16]}.so")


def _run(procs) -> str:
    """Wait for every (command, process) and return their output; raise with
    nvcc's output if one failed."""
    out = ""
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{stdout}{stderr}")
        out += stdout + stderr
    return out


def _build(so: str) -> None:
    """One nvcc for each source, all started together, then one link."""
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        procs = []
        for src, obj in zip(_sources(), objs):
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        log = _run(procs)
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG = log


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            p, i = ctypes.c_void_p, ctypes.c_int
            for name in ("mpx_k1_sweep_f32", "mpx_k1_sweep_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p,                # U, inv, Uc, inv_c
                               i, i, i, i, i, i, i, i,    # m, r0, c0, S, W, w, wc, excl
                               p, p, p, p,                # row/col partials
                               p, p, p, p,                # row/col outputs
                               p]                         # stream
                fn.restype = i
            for name in ("mpx_k3_sweep_f32", "mpx_k3_sweep_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p, p, p,  # row df/dg/inv, col df/dg/inv, seed
                               i, i, i, i, i, i,     # r0, k0, S, W, w, excl
                               p,                    # segment sums
                               p, p, p, p,           # row/col partials
                               p, p, p, p,           # row/col outputs
                               p]                    # stream
                fn.restype = i
            for name in ("mpx_k1_block_m", "mpx_k1_block_n", "mpx_k3_block_w",
                         "mpx_k3_segment_rows", "mpx_k3_block_columns"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            lib.mpx_k3_resident_blocks.argtypes = [i, i]  # f64, which kernel
            lib.mpx_k3_resident_blocks.restype = i
            _LIB = lib
        return _LIB
