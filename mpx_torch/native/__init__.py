"""ctypes bindings for the host C++ library (``scamp_host.cpp``), the
counterpart of ``mpx/native``.

``scamp_host.cpp`` is this package's own copy of mpx's source, byte for
byte: exact float64 statistics (``precompute``, ``precompute_stats``), the
O(n^2) golden SCAMP, the exact pair and row scorers and the aggregate
merge, at C speed with OpenMP.  It is built with g++ and mpx's flags at
first use into ``mpx_torch/_build/``; the library's name carries a hash of
the source, the flags and the flags ``-march=native`` resolves to on this
host, and it is built under a temporary name and moved into place, so
processes that build at once never load half a file.  A failed build
raises with g++'s output, and no entry point falls back to numpy: callers
choose a statistics backend explicitly
(:func:`mpx_torch.ops.precompute.host_statistics`), and
:func:`is_available` serves the ``--version`` banner.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "scamp_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]

_LOCK = threading.Lock()
_LIB = None


def _compiler_output(cmd) -> str:
    """Run the compiler; raise with its output if it cannot run or fails."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build failed: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def library_path() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    # -march=native differs between hosts that may share one checkout.
    h.update(_compiler_output([CXX, "-march=native", "-Q", "--help=target"]).encode())
    return os.path.join(BUILD_DIR, f"libscamp_host_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        _compiler_output([CXX, *CXX_FLAGS, _SRC, "-o", tmp])
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib):
    i64, f64p, i32p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    )
    sigs = {
        "mpx_precompute": [f64p, i64, i64, f64p, f64p, f64p, f64p, f64p],
        "mpx_precompute_stats": [f64p, i64, i64, f64p, f64p],
        "mpx_golden_scamp": [f64p, i64, i64, f64p, i32p],
        "mpx_merge_aggregates": [f64p, i32p, f64p, i32p, i64],
        "mpx_rescore": [f64p, f64p, f64p, i64, i32p, i32p, i64, f64p],
        "mpx_resolve_sym": [f64p, f64p, f64p, i64, i32p, i32p, i64, f64p, i32p],
        "mpx_resolve_slots": [f64p, f64p, f64p, i64, i32p, i64, i64, f64p, i32p],
        "mpx_resolve_slots_ab": [f64p, f64p, f64p, f64p, f64p, f64p, i64, i32p, i64, i64,
                                 i64, f64p, i32p],
        "mpx_row_scan": [f64p, f64p, f64p, i64, i64, i64, i32p, i64, f64p, i32p],
        "mpx_rescore_ab": [f64p, f64p, f64p, f64p, f64p, f64p, i64, i32p, i32p, i64, f64p],
        "mpx_row_scan_ab": [f64p, f64p, f64p, f64p, f64p, f64p, i64, i64, i64, i32p, i64,
                            f64p, i32p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def load():
    """The library, built first if needed; raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            _LIB = _bind(ctypes.CDLL(so))
        return _LIB


def is_available() -> bool:
    """Whether the library loads (building it if needed): the ``--version``
    banner's line, never a backend choice."""
    return build_error() is None


def build_error() -> str | None:
    """None when the library loads, else the first line of the error."""
    try:
        load()
        return None
    except (RuntimeError, OSError) as e:
        return str(e).splitlines()[0]


def _f64(*xs):
    return [np.ascontiguousarray(x, np.float64) for x in xs]


def _i32(x):
    return np.ascontiguousarray(x, np.int32)


def precompute(T: np.ndarray, m: int):
    """Exact float64 statistics in one pass: the running mean, ``df``,
    ``dg``, the two-pass ``inv`` and the centered first-row products
    ``qt0``."""
    lib = load()
    (T,) = _f64(T)
    w = T.shape[0] - m + 1
    out = {k: np.empty(w) for k in ("mu", "df", "dg", "inv", "qt0")}
    lib.mpx_precompute(T, T.shape[0], m, out["mu"], out["df"], out["dg"], out["inv"],
                       out["qt0"])
    return out


def precompute_stats(T: np.ndarray, m: int):
    """Exact float64 ``mu`` and ``inv`` only (the windows-matmul tiers'
    statistics): no ``df``/``dg``/``qt0``, and the reduction vectorized
    across 8 windows with even/odd accumulators where the host has
    AVX-512."""
    lib = load()
    (T,) = _f64(T)
    w = T.shape[0] - m + 1
    mu, inv = np.empty(w), np.empty(w)
    lib.mpx_precompute_stats(T, T.shape[0], m, mu, inv)
    return {"mu": mu, "inv": inv}


def golden_scamp(T: np.ndarray, m: int):
    """O(n^2) golden SCAMP at C speed (OpenMP over diagonals)."""
    lib = load()
    (T,) = _f64(T)
    w = T.shape[0] - m + 1
    MP = np.empty(w)
    MPI = np.empty(w, dtype=np.int32)
    lib.mpx_golden_scamp(T, T.shape[0], m, MP, MPI)
    return MP, MPI


def rescore(T, mu, inv, m: int, rows, cols):
    """Exact f64 Pearson P for explicit (rows[i], cols[i]) pairs."""
    lib = load()
    T, mu, inv = _f64(T, mu, inv)
    rows, cols = _i32(rows), _i32(cols)
    P = np.empty(rows.shape[0], np.float64)
    lib.mpx_rescore(T, mu, inv, m, rows, cols, rows.shape[0], P)
    return P


def resolve_sym(T, mu, inv, m: int, rows, cols, w: int):
    """Self-join pair resolution: exact f64 P of each unordered (rows[i],
    cols[i]) pair merged into both endpoints' best under the
    strict-greater, smallest-index-tie rule.  Returns (bestP (w,), bestI
    (w,)), initialized to the aggregate inits."""
    lib = load()
    T, mu, inv = _f64(T, mu, inv)
    rows, cols = _i32(rows), _i32(cols)
    bestP = np.full(w, -1e12, np.float64)
    bestI = np.full(w, -1, np.int32)
    lib.mpx_resolve_sym(T, mu, inv, m, rows, cols, rows.shape[0], bestP, bestI)
    return bestP, bestI


def resolve_slots(T, mu, inv, m: int, cand, w: int):
    """Self-join resolution from the raw (w, nslots) capture matrix:
    dedupe, symmetric-pair filtering, exact f64 scoring and both-end
    merging in one C pass."""
    lib = load()
    T, mu, inv = _f64(T, mu, inv)
    cand = _i32(cand)
    bestP = np.full(w, -1e12, np.float64)
    bestI = np.full(w, -1, np.int32)
    lib.mpx_resolve_slots(T, mu, inv, m, cand, w, cand.shape[1], bestP, bestI)
    return bestP, bestI


def resolve_slots_ab(Tq, muq, invq, Tt, mut, invt, m: int, cand, wq: int, wt: int):
    """One-sided slot resolution (left/right and AB-joins): each query
    row's best over its raw capture slots, scored exactly against the
    target series."""
    lib = load()
    args = _f64(Tq, muq, invq, Tt, mut, invt)
    cand = _i32(cand)
    bestP = np.full(wq, -1e12, np.float64)
    bestI = np.full(wq, -1, np.int32)
    lib.mpx_resolve_slots_ab(*args, m, cand, wq, wt, cand.shape[1], bestP, bestI)
    return bestP, bestI


def row_scan(T, mu, inv, m: int, w: int, excl: int, rows):
    """Exact f64 best (P, index) over all valid neighbors of each row."""
    lib = load()
    T, mu, inv = _f64(T, mu, inv)
    rows = _i32(rows)
    bestP = np.empty(rows.shape[0], np.float64)
    bestI = np.empty(rows.shape[0], np.int32)
    lib.mpx_row_scan(T, mu, inv, m, w, excl, rows, rows.shape[0], bestP, bestI)
    return bestP, bestI


def rescore_ab(Tq, muq, invq, Tt, mut, invt, m: int, rows, cols):
    """Exact f64 Pearson for (query rows[i], target cols[i]) pairs."""
    lib = load()
    args = _f64(Tq, muq, invq, Tt, mut, invt)
    rows, cols = _i32(rows), _i32(cols)
    P = np.empty(rows.shape[0], np.float64)
    lib.mpx_rescore_ab(*args, m, rows, cols, rows.shape[0], P)
    return P


def row_scan_ab(Tq, muq, invq, Tt, mut, invt, m: int, wt: int, excl: int, rows):
    """Exact f64 best target neighbor of each query row (excl < 0: no
    exclusion zone)."""
    lib = load()
    args = _f64(Tq, muq, invq, Tt, mut, invt)
    rows = _i32(rows)
    bestP = np.empty(rows.shape[0], np.float64)
    bestI = np.empty(rows.shape[0], np.int32)
    lib.mpx_row_scan_ab(*args, m, wt, excl, rows, rows.shape[0], bestP, bestI)
    return bestP, bestI


def merge_aggregates(a_val, a_idx, b_val, b_idx):
    """Merge b's (value, index) aggregates into a's in place (strict
    greater wins); returns (a_val, a_idx)."""
    lib = load()
    a_val, a_idx = np.ascontiguousarray(a_val, np.float64), _i32(a_idx)
    (b_val,), b_idx = _f64(b_val), _i32(b_idx)
    lib.mpx_merge_aggregates(a_val, a_idx, b_val, b_idx, a_val.shape[0])
    return a_val, a_idx
