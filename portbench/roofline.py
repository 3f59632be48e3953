"""The yardstick's arithmetic: the card's published peaks, the pairs a
self-join holds, and the least time any exact method could take for it.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates at
its full 700 W power limit (a card set below it runs slower under load;
the benchmark reports the limit it read beside every run).

The least time reads the same work whatever implements the sweep: a
windows matmul (2m FLOPs a pair), the SCAMP recurrence or any later
kernel.  It is the larger of

* operations: ``LEAST_FLOPS_PER_PAIR`` for each pair outside the
  exclusion zone, at the highest rate the card publishes for the dtype
  (FP64: the tensor cores' 67 TFLOP/s; FP32: 67 TFLOP/s outside the
  tensor cores, since TF32 is not float32);
* bytes: the series and each window's statistics read once, the profile
  and its index written once, at the HBM's 3.35 TB/s.

``LEAST_FLOPS_PER_PAIR`` is 4: the recurrence's update of one pair's
co-moment, ``QT[i, j] = QT[i-1, j-1] + df[i] dg[j] + df[j] dg[i]``, is two
fused multiply-adds.  Normalizing, comparing and the row and column
maxima cost more; leaving them out keeps the bound a lower bound, so no
implementation reads above 100 % of it.
"""

from __future__ import annotations

H100_SXM = {
    "name": "NVIDIA H100 SXM5 80GB",
    "power_limit_w": 700.0,
    "flops": {"float64": 67e12, "float32": 67e12},
    "hbm_bytes_per_s": 3.35e12,
}
LEAST_FLOPS_PER_PAIR = 4
# float64 statistics a window needs (mean, inverse norm, df, dg).
_STATS_PER_WINDOW = 4


def windows(n: int, m: int) -> int:
    return n - m + 1


def pairs(n: int, m: int) -> int:
    """Pairs of a self-join, w(w-1)/2: the upper triangle, exclusion-zone
    pairs included (the convention of ``pairs_per_s``)."""
    w = windows(n, m)
    return w * (w - 1) // 2


def pairs_outside_zone(n: int, m: int) -> int:
    """Pairs (i, j), i < j, with j - i >= m // 4: those a method must
    compute."""
    w, e = windows(n, m), max(m // 4, 1)
    k = w - e
    return k * (k + 1) // 2 if k > 0 else 0


def least_bytes(n: int, m: int, itemsize: int = 8) -> int:
    w = windows(n, m)
    return n * itemsize + w * 8 * _STATS_PER_WINDOW + w * (itemsize + 4)


def least_seconds(n: int, m: int, dtype: str, peaks: dict = H100_SXM) -> float:
    """The least time the card could take for one self-join of a series of
    ``n`` points at window ``m`` in ``dtype``: no argument names a kernel."""
    itemsize = 8 if dtype == "float64" else 4
    flops = LEAST_FLOPS_PER_PAIR * pairs_outside_zone(n, m)
    return max(flops / peaks["flops"][dtype],
               least_bytes(n, m, itemsize) / peaks["hbm_bytes_per_s"])
