"""The comparison catches the faults each cell can have: the whole run
rehearsed with the timed path broken underneath, and ``correct`` false.
(The cells run on one card, so there is no exchange between cards to
leave out.)"""

import numpy as np
import pytest
import torch

import mpx_torch.driver as program
from mpx_torch.streaming import StreamingMatrixProfile
from mpx_torch.types import JobGrid
from portbench.tests.tiny import TINY, rehearse

JOIN_CELLS = ["showcase-f64.selfjoin"]
# Sizes at which the library's default band cuts a self-join into jobs.
SEVERAL_JOBS = {
    "showcase-f64.selfjoin": {"config": {"m": 16, "data": {"kind": "random_walk",
                                                           "length": 5000}},
                              "traffic": {"warmup_length": 256,
                                          "check": {"share": 1.0, "rows": "all"}}},
}


def _half_the_jobs(real):
    def grid(w, band, chunk):
        g = real(w, band, chunk)
        keep = slice(0, None, 2)
        return JobGrid(r0=g.r0[keep], k0=g.k0[keep], band=g.band, chunk=g.chunk)
    return grid


def _one_answer_altered(real):
    def post(rows, cols, m, w):
        MP, MPI = real(rows, cols, m, w)
        MP = MP.clone()
        MP[w // 2] += 1e-6
        return MP, MPI
    return post


@pytest.mark.parametrize("workload", JOIN_CELLS)
def test_sound_join_cells_are_correct(workload):
    assert rehearse(workload)["correct"] is True
    assert rehearse(workload, seconds=0.1, overrides=SEVERAL_JOBS[workload])["correct"] is True


@pytest.mark.parametrize("workload", JOIN_CELLS)
def test_half_the_jobs_left_out_is_caught(workload, monkeypatch):
    monkeypatch.setattr(program, "make_job_grid", _half_the_jobs(program.make_job_grid))
    r = rehearse(workload, seconds=0.1, overrides=SEVERAL_JOBS[workload])
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["dist_err"]["value"] > 1e-8


@pytest.mark.parametrize("workload", JOIN_CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(workload, monkeypatch):
    monkeypatch.setattr(program, "postcompute", _one_answer_altered(program.postcompute))
    r = rehearse(workload, seconds=0.1)
    assert r["correct"] is False
    assert r["checks"]["dist_err"]["value"] == pytest.approx(1e-6, rel=1e-3)


def test_an_append_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(StreamingMatrixProfile, "append", lambda self, points: None)
    r = rehearse("showcase-f64.append", seconds=0.1)
    assert r["correct"] is False


def test_an_append_whose_merge_is_skipped_is_caught(monkeypatch):
    """The new rows land but the columns they improve are left alone."""
    real = StreamingMatrixProfile._sweep

    def sweep(self, r_off, w):
        rv, ri, (cv, ci) = real(self, r_off, w)
        return rv, ri, (torch.full_like(cv, -torch.inf), ci)

    monkeypatch.setattr(StreamingMatrixProfile, "_sweep", sweep)
    r = rehearse("showcase-f64.append", seconds=0.3)
    assert r["correct"] is False and r["checks"]["index_bad"]["value"] >= 1


def test_an_append_read_altered_where_it_is_produced_is_caught(monkeypatch):
    real = StreamingMatrixProfile.row_values

    def row_values(self, lo, hi):
        return real(self, lo, hi) + 1e-6

    monkeypatch.setattr(StreamingMatrixProfile, "row_values", row_values)
    r = rehearse("showcase-f64.append", seconds=0.1)
    assert r["correct"] is False
    assert r["checks"]["read_err"]["value"] == pytest.approx(1e-6, rel=1e-3)
    assert r["checks"]["dist_err"]["value"] <= 1e-8


def test_the_lower_precision_control_is_caught():
    """The control: the program's float32 path where the configuration
    states float64."""
    for workload in ("showcase-f64.selfjoin", "showcase-f64.append"):
        ov = dict(TINY[workload], config=dict(TINY[workload]["config"], dtype="float32"))
        r = rehearse(workload, overrides=ov)
        assert r["correct"] is False
        assert r["checks"]["dist_err"]["value"] > 1e-6
