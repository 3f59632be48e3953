"""Arbitrary-precision fixed-point input tier (the ap_fixed analog),
counterpart of ``mpx/io/apfixed.py`` (numpy only; same values, same files).

The reference defines four fixed-point compute dtypes
(include/ArbitraryPrecisionFixed.hpp:18-37):

* ``ap16`` — ap_fixed<16, 5>:  5 integer bits (incl. sign), 11 fraction
* ``ap24`` — ap_fixed<24, 8>:  8 integer bits, 16 fraction
* ``ap32`` — ap_fixed<32, 11>: 11 integer bits, 21 fraction
* ``ap64`` — ap_fixed<64, 14>: 14 integer bits, 50 fraction

all with AP_RND_ZERO (round toward zero) and AP_WRAP_SM overflow.  Its
host reads double input and casts element-wise, rejecting values outside
the "safe" integral range [-2^(I-1), 2^(I-1)-1] (include/host/FileIO.hpp:
50-103; the check deliberately uses integral bounds, not the true ap
extremes).

The GPU has no fixed-point datapath for this work either, so the input is
quantized once, exactly as the reference's FileIO cast, and then computed
on through the float tiers (ap16/ap24 in float32, ap32/ap64 in float64;
see :class:`mpx_torch.config.MatrixProfileConfig`).

The float64 quantizer is exact: scaling a binary float by 2^F only
changes its exponent, truncating a float64 is exact, and every truncated
mantissa fits back into float64 (|x| < 4 keeps <= 52 significant bits
after truncation to the 2^-F grid; |x| >= 4 is already on the grid for
F = 50).  So ``trunc(x * 2**F) * 2**-F`` equals the ap_fixed cast for all
four formats.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ApFixedFormat:
    """ap_fixed<W, I, AP_RND_ZERO, AP_WRAP_SM> geometry."""

    name: str
    width: int    # W: total bits
    integer: int  # I: integer bits, sign included

    @property
    def fraction(self) -> int:
        return self.width - self.integer

    @property
    def scale(self) -> float:
        return float(2.0 ** self.fraction)

    # The reference's "safe-range" bounds (FileIO.hpp:50-65): integral
    # min/max, not the true ap extremes.
    @property
    def min_value(self) -> float:
        return float(-(1 << (self.integer - 1)))

    @property
    def max_value(self) -> float:
        return float((1 << (self.integer - 1)) - 1)

    @property
    def storage_dtype(self) -> np.dtype:
        """Smallest little-endian signed container for W-bit mantissas."""
        for code, bits in (("<i2", 16), ("<i4", 32), ("<i8", 64)):
            if self.width <= bits:
                return np.dtype(code)
        raise ValueError(f"ap width {self.width} > 64 unsupported")


FORMATS = {
    "ap16": ApFixedFormat("ap16", 16, 5),
    "ap24": ApFixedFormat("ap24", 24, 8),
    "ap32": ApFixedFormat("ap32", 32, 11),
    "ap64": ApFixedFormat("ap64", 64, 14),
}


def get_format(name: str) -> ApFixedFormat:
    key = str(name).lower()
    if key not in FORMATS:
        raise ValueError(
            f"Unknown ap_fixed format '{name}'. Has to be one of: "
            f"{', '.join(FORMATS)}"
        )
    return FORMATS[key]


def _fmt(fmt_or_name) -> ApFixedFormat:
    return fmt_or_name if isinstance(fmt_or_name, ApFixedFormat) else get_format(fmt_or_name)


def check_range(x: np.ndarray, fmt: ApFixedFormat, context: str = "input"):
    """The reference's safe-range check (FileIO.hpp:92-99): every value
    must lie in [min_value, max_value]; the first offender is reported."""
    x = np.asarray(x, np.float64)
    bad = (x < fmt.min_value) | (x > fmt.max_value) | ~np.isfinite(x)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"{context} contains value {x[i]!r} at index {i} not contained "
            f"in \"safe-range\"! Expected value between {fmt.min_value} "
            f"and {fmt.max_value} ({fmt.name})"
        )


def quantize(x, fmt_or_name, check: bool = True) -> np.ndarray:
    """Cast double input to the ap_fixed grid as the reference's FileIO
    read does (FileIO.hpp:66-103): optional safe-range check, then
    AP_RND_ZERO (truncate toward zero) at W-I fraction bits.  Returns
    float64 values that lie exactly on the grid."""
    fmt = _fmt(fmt_or_name)
    x = np.asarray(x, np.float64)
    if check:
        check_range(x, fmt)
    return np.trunc(x * fmt.scale) / fmt.scale


def to_raw(x, fmt_or_name, check: bool = True) -> np.ndarray:
    """Quantize and return the integer mantissas (value * 2^F)."""
    fmt = _fmt(fmt_or_name)
    x = np.asarray(x, np.float64)
    if check:
        check_range(x, fmt)
    return np.trunc(x * fmt.scale).astype(fmt.storage_dtype)


def from_raw(raw: np.ndarray, fmt_or_name) -> np.ndarray:
    """Integer mantissas -> float64 values (exact for all four formats)."""
    return np.asarray(raw, np.float64) / _fmt(fmt_or_name).scale


def quantization_error_bound(fmt_or_name) -> float:
    """|x - quantize(x)| < 2^-F (truncation toward zero)."""
    return 1.0 / _fmt(fmt_or_name).scale


# ---------------------------------------------------------------------------
# On-disk container (an mpx extension: the reference stores doubles and
# casts in memory).  Layout: 16-byte header (magic 'MPXQ', u8 W, u8 I, u16
# reserved = 0, u64 count, little-endian) + count little-endian mantissas.
# ---------------------------------------------------------------------------

_MAGIC = b"MPXQ"
_HEADER = struct.Struct("<4sBBHQ")


def write_quantized(path: str, data, fmt_or_name, check: bool = True) -> None:
    fmt = _fmt(fmt_or_name)
    raw = to_raw(data, fmt, check=check)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, fmt.width, fmt.integer, 0, raw.shape[0]))
        f.write(raw.tobytes())


def is_quantized_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def read_quantized(path: str, n: Optional[int] = None) -> np.ndarray:
    """Read an MPXQ container as exact float64 values, with the
    reference-style strict size check (FileIO.hpp:38-47)."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size or head[:4] != _MAGIC:
            raise ValueError(f"{path} is not an MPXQ quantized container")
        _, width, integer, _, count = _HEADER.unpack(head)
        fmt = next((c for c in FORMATS.values()
                    if c.width == width and c.integer == integer),
                   ApFixedFormat(f"ap_fixed<{width},{integer}>", width, integer))
        if n is not None and count != n:
            raise ValueError(
                f"{path} contains unexpected number of elements: expected "
                f"{n}, header says {count}"
            )
        payload = f.read()
    expect = count * fmt.storage_dtype.itemsize
    if len(payload) != expect:
        raise ValueError(
            f"{path} payload is {len(payload)} bytes; header promises "
            f"{count} element(s) [i.e. {expect} bytes]"
        )
    return from_raw(np.frombuffer(payload, dtype=fmt.storage_dtype), fmt)
