"""Consensus motifs (``mpx_torch.ostinato``) and snippets
(``mpx_torch.snippets``) of mpx_torch, on the CPU, against mpx's.

Both are compositions of AB-joins (the port's plain sweep here, K1 on the
card): radii within 1e-8 (float64) / 2e-3 (float32) of mpx's, the same
consensus window and the same snippets where no two candidates tie.
"""

import numpy as np
import pytest

import mpx
from mpx.ostinato import ostinato as mpx_ostinato
from mpx.snippets import snippets as mpx_snippets
from mpx_torch import MatrixProfileConfig, ostinato, snippets
from mpx_torch.ostinato import ConsensusMotif
from mpx_torch.snippets import Snippet
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
M = 32


def _planted(lengths=(1100, 900, 1300), seed=81):
    """Walks with a noisy copy of one shape each (the consensus motif)."""
    rng = np.random.default_rng(seed)
    shape = np.cumsum(rng.standard_normal(64))
    out = []
    for i, n in enumerate(lengths):
        T = random_walk(n, seed=seed + 1 + i)
        at = 150 + 250 * i
        T[at : at + 64] = T[at] + shape + 0.05 * rng.standard_normal(64)
        out.append(T)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ostinato_equals_mpxs(dtype):
    series = _planted()
    ours = ostinato(series, config=MatrixProfileConfig(m=M, dtype=dtype, band=256,
                                                       chunk=512, device="cpu"))
    ref = mpx_ostinato(series, config=mpx.MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512))
    assert isinstance(ours, ConsensusMotif)
    assert (ours.series, ours.index) == (ref.series, ref.index)
    assert abs(ours.radius - ref.radius) <= EPS[dtype]
    assert len(ours.radii) == 3
    for a, b in zip(ours.radii, ref.radii):
        np.testing.assert_allclose(a, b, rtol=0, atol=EPS[dtype])
    at = 150 + 250 * ours.series
    assert at <= ours.index <= at + 64 - M


def test_ostinato_refusals():
    cfg = MatrixProfileConfig(m=M, device="cpu")
    with pytest.raises(ValueError, match="at least two"):
        ostinato([random_walk(200)], config=cfg)
    with pytest.raises(ValueError, match="conflicts"):
        ostinato([random_walk(200)] * 2, m=16, config=cfg)


@pytest.mark.parametrize("dtype,k", [("float64", 2), ("float64", 3), ("float32", 2)])
def test_snippets_equal_mpxs(dtype, k):
    # three regimes of differing shape, so the candidates do not tie
    t = np.arange(3000)
    T = np.where(t < 1000, np.sin(t / 8.0), np.where(t < 2200, np.sign(np.sin(t / 13.0)),
                                                      np.sin(t / 5.0) ** 3))
    T = T + 0.05 * np.random.default_rng(83).standard_normal(3000)
    ours = snippets(T, 200, k=k, config=MatrixProfileConfig(m=64, dtype=dtype, band=256,
                                                            chunk=512, device="cpu"))
    ref = mpx_snippets(T, 200, k=k, config=mpx.MatrixProfileConfig(
        m=64, dtype=dtype, band=256, chunk=512))
    assert all(isinstance(s, Snippet) for s in ours)
    assert [(s.start, s.length, s.index) for s in ours] == \
        [(s.start, s.length, s.index) for s in ref]
    np.testing.assert_allclose([s.fraction for s in ours], [s.fraction for s in ref],
                               rtol=0, atol=1e-12)
    assert abs(sum(s.fraction for s in ours) - 1.0) < 1e-12


def test_snippets_refusals_match_mpxs():
    T = random_walk(500)
    for fn in (snippets, mpx_snippets):
        with pytest.raises(ValueError, match="must be >= m"):
            fn(T, 16, m=32)
        with pytest.raises(ValueError, match="no L="):
            fn(T, 600)
        with pytest.raises(ValueError, match="k must be"):
            fn(T, 100, k=0)
