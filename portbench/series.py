"""The one generator of inputs: every series a cell sends is drawn from
the run's seed and the parameters in its configuration.

Configuration ``data``: ``{"kind": "random_walk", "length": n}`` — the
cumulative sum of standard normal steps, a fresh walk for every request.
"""

from __future__ import annotations

import numpy as np

_U64 = 1 << 64


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of the run's seed (any integer)."""
    return np.random.default_rng([seed % _U64, *stream])


def random_walk(g: np.random.Generator, n: int) -> np.ndarray:
    return np.cumsum(g.standard_normal(n))


class Requests:
    """The series of request ``i`` of a run, from the seed alone."""

    # stream ids of the seed
    SERIES, STREAM, CHECK = 1, 4, 5

    def __init__(self, config: dict, seed: int):
        self.seed = seed
        self.data = config["data"]
        if self.data["kind"] != "random_walk":
            raise ValueError(f"unknown data kind {self.data['kind']!r}")

    def series(self, i: int) -> np.ndarray:
        """Request ``i``'s series: a fresh walk."""
        return random_walk(rng(self.seed, self.SERIES, i), int(self.data["length"]))

    def stream(self, start: float, chunk: int):
        """Points that continue a walk ending at ``start``, ``chunk`` at a
        time, forever."""
        g = rng(self.seed, self.STREAM)
        last = start
        while True:
            pts = last + np.cumsum(g.standard_normal(chunk))
            last = pts[-1]
            yield from pts
