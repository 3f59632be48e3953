"""Binary/ascii time-series codecs, counterpart of ``mpx/io/tsb.py``
(numpy only, byte-compatible with mpx's files).

* ``.tsb``  — raw little-endian float64 time series (n values)
* ``.mpb``  — raw little-endian float64 matrix profile (n - m + 1 values)
* ``.mpib`` — raw little-endian int32 matrix profile index
* ``.txt`` / ``.txt.gz`` — whitespace-separated ascii
* MPXQ fixed-point containers (:mod:`mpx_torch.io.apfixed`), found by
  their magic whatever the extension

A binary file must hold a whole number of elements, and exactly ``n``
of them when ``n`` is given.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from mpx_torch.io.apfixed import is_quantized_file, read_quantized

_BINARY_DTYPES = {
    "double": np.dtype("<f8"),
    "int": np.dtype("<i4"),
}


def _dtype_for(type_name: str) -> np.dtype:
    if type_name not in _BINARY_DTYPES:
        raise ValueError(
            f"Unknown type '{type_name}'. Type has to be one of: "
            f"{', '.join(_BINARY_DTYPES)}"
        )
    return _BINARY_DTYPES[type_name]


def read_binary(path: str, type_name: str = "double", n: Optional[int] = None) -> np.ndarray:
    dt = _dtype_for(type_name)
    size = os.path.getsize(path)
    if size % dt.itemsize != 0:
        raise ValueError(
            f"{path} contains {size} bytes, not a multiple of {dt.itemsize} "
            f"bytes (type = {type_name})"
        )
    if n is not None and size != n * dt.itemsize:
        raise ValueError(
            f"{path} contains unexpected number of elements: expected {n} "
            f"[{n * dt.itemsize} bytes], file contains {size} bytes"
        )
    return np.fromfile(path, dtype=dt)


def write_binary(path: str, data, type_name: str = "double") -> None:
    dt = _dtype_for(type_name)
    np.asarray(data).astype(dt).tofile(path)


def read_ascii(path: str) -> np.ndarray:
    """Whitespace-separated floats from .txt or .txt.gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    return np.array([float(x) for x in text.split()], dtype=np.float64)


def write_ascii(path: str, data, oneline: bool = False) -> None:
    """One value a line (or one line), each as Python's ``repr``."""
    sep = " " if oneline else "\n"
    with open(path, "w") as f:
        f.write(sep.join(repr(float(x)) for x in np.asarray(data)) + "\n")


def read_series(path: str) -> np.ndarray:
    """Load a time series from any supported container: an MPXQ container
    by its magic (its exact quantized values), else by extension."""
    if is_quantized_file(path):
        return read_quantized(path)
    if path.endswith(".tsb") or path.endswith(".mpb"):
        return read_binary(path, "double")
    if path.endswith(".mpib"):
        return read_binary(path, "int")
    if path.endswith(".txt") or path.endswith(".gz"):
        return read_ascii(path)
    return read_binary(path, "double")


def write_results(base_path: str, MP, MPI) -> tuple[str, str]:
    """Persist MP/MPI as <base>.mpb / <base>.mpib."""
    mpb = base_path + ".mpb"
    mpib = base_path + ".mpib"
    write_binary(mpb, MP, "double")
    write_binary(mpib, np.asarray(MPI, dtype=np.int32), "int")
    return mpb, mpib
