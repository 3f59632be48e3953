"""Exact multi-length discords and motifs of mpx_torch (``mpx_torch.merlin``,
on the CPU) against the port's brute force (``reference.py``) and mpx's
``multi_length_discords`` / ``multi_length_motifs`` on the same seeded
inputs, within 1e-9, through both escalations (forced by monkeypatching the
port's constants, as ``tests/test_merlin.py`` does mpx's).
"""

import numpy as np
import pytest

import mpx
from mpx_torch import MatrixProfileConfig, merlin
from mpx_torch.merlin import (
    brute_force_multi_length_discords,
    brute_force_multi_length_motifs,
    multi_length_discords,
    multi_length_motifs,
)
from mpx_torch.utils.profile import BenchmarkProfile

CFG = MatrixProfileConfig(m=8, device="cpu")


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _periodic(seed):
    t = np.arange(700)
    return np.sin(2 * np.pi * t / 40) + 1e-3 * np.random.default_rng(seed).standard_normal(700)


def assert_per_length_exact(got, want):
    assert [d.m for d in got] == [d.m for d in want]
    for g, e in zip(got, want):
        assert g.distance == pytest.approx(e.distance, abs=1e-9)
        assert g.score == pytest.approx(g.distance / (2 * np.sqrt(g.m)))


def test_discords_equal_the_brute_force_and_mpx():
    T = _walk(800, 11)
    T[400:416] += np.linspace(0, 9, 16)
    prof = BenchmarkProfile()
    res = multi_length_discords(T, 8, 13, k=3, config=CFG, profile=prof)
    assert res.exact and not res.escalated_lengths and not res.truncated_lengths
    assert_per_length_exact(res.per_length, brute_force_multi_length_discords(T, range(8, 14)))
    ref = mpx.multi_length_discords(T, 8, 13, k=3)
    assert_per_length_exact(res.per_length, ref.per_length)
    assert [d.index for d in res.per_length] == [d.index for d in ref.per_length]
    scores = [d.score for d in res.top]
    assert scores == sorted(scores, reverse=True) and len(res.top) <= 3
    for a, b in zip(res.top, res.top[1:]):
        assert not (a.index < b.index + b.m and b.index < a.index + a.m)
    assert "4. Refine [merlin f64]" in prof.category_totals()
    for m in range(8, 14):
        assert prof.counts[f"candidates_m{m}"] >= 1
        assert prof.counts[f"survey_err_m{m}"] < merlin._DEFAULT_EPS


def test_motifs_equal_the_brute_force_and_mpx():
    rng = np.random.default_rng(31)
    T = 0.05 * rng.standard_normal(800)
    pat = np.sin(np.linspace(0, 3 * np.pi, 40)) * 3
    T[100:140] += pat
    T[500:540] += pat
    ms = [16, 24, 32, 40]
    res = multi_length_motifs(T, ms=ms, k=2, config=CFG)
    assert_per_length_exact(res.per_length, brute_force_multi_length_motifs(T, ms))
    assert_per_length_exact(res.per_length, mpx.multi_length_motifs(T, ms=ms, k=2).per_length)
    at40 = res.per_length[-1]
    a, b = sorted((at40.index, at40.nn_index))
    assert abs(b - a - 400) <= 4 and 85 <= a <= 115
    scores = [d.score for d in res.top]
    assert scores == sorted(scores)
    spans = [s for d in res.top for s in ((d.index, d.index + d.m),
                                          (d.nn_index, d.nn_index + d.m))]
    for x in range(len(spans)):
        for y in range(x + 1, len(spans)):
            assert not (spans[x][0] < spans[y][1] and spans[y][0] < spans[x][1])


@pytest.mark.parametrize("mode", ["discords", "motifs"])
def test_band_overflow_escalates_exactly(monkeypatch, mode):
    """A near-flat profile overflows a lowered candidate cap: the lengths
    are re-swept through the hybrid tier and stay exact."""
    monkeypatch.setattr(merlin, "_MAX_CANDIDATES", 8)
    T = _periodic(44)
    fn, brute = {"discords": (multi_length_discords, brute_force_multi_length_discords),
                 "motifs": (multi_length_motifs, brute_force_multi_length_motifs)}[mode]
    res = fn(T, ms=[16, 24], config=CFG)
    assert res.escalated_lengths and res.exact and not res.truncated_lengths
    assert_per_length_exact(res.per_length, brute(T, [16, 24]))


def test_truncation_without_escalation_is_visible(monkeypatch):
    monkeypatch.setattr(merlin, "_MAX_CANDIDATES", 8)
    res = multi_length_discords(_periodic(45), ms=[16, 24], escalate=False, config=CFG)
    assert res.truncated_lengths and not res.exact and not res.escalated_lengths


def test_eps_violation_escalates_exactly():
    """An eps far below the real survey error trips the run-time check and
    escalates every length; the result stays exact."""
    T = _walk(600, 46)
    res = multi_length_discords(T, ms=[12, 20], eps=1e-12, config=CFG)
    assert set(res.escalated_lengths) == {12, 20} and res.exact
    assert_per_length_exact(res.per_length, brute_force_multi_length_discords(T, [12, 20]))
    res = multi_length_discords(T, ms=[12, 20], eps=1e-12, escalate=False, config=CFG)
    assert set(res.truncated_lengths) == {12, 20} and not res.exact


@pytest.mark.parametrize("args,kw", [((), {}), ((2, 10), {}), ((20, 10), {}),
                                     ((8, 16), {"k": 0}), ((), {"ms": []})])
def test_value_errors(args, kw):
    for fn in (multi_length_discords, multi_length_motifs):
        with pytest.raises(ValueError):
            fn(_walk(100, 14), *args, config=CFG, **kw)
