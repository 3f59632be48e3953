"""The streaming profile of mpx_torch (``mpx_torch.streaming``, on the CPU)
against mpx's ``StreamingMatrixProfile`` and against the port's batch
profiles of the same series, in all three modes, after appends that cross
a capacity doubling.  Tolerances: 1e-8 (float64) / 2e-3 (float32) on
distances, indices only between equidistant neighbours
(``tests/helpers.py:assert_profile_close``).
"""

import numpy as np
import pytest

from mpx.streaming import StreamingMatrixProfile as MpxStreaming
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.streaming import StreamingMatrixProfile
from tests.helpers import assert_profile_close

EPS = {"float64": 1e-8, "float32": 2e-3}


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _batch(T, m, mode):
    """The port's batch profile of T for the streaming mode."""
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=256, chunk=512, device="cpu")
    if mode == "full":
        return [o.numpy() for o in compute_matrix_profile(T, config=cfg)]
    out = [o.numpy() for o in compute_matrix_profile(T, config=cfg, left_right=True)]
    return out[2:] if mode == "right" else out[:2]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full", "right", "left"])
def test_appends_across_a_doubling_match_mpx_and_the_batch(mode, dtype):
    T = _walk(1400, 5)
    m = 16
    ours = StreamingMatrixProfile(T[:900], m, dtype, mode, device="cpu")
    ref = MpxStreaming(T[:900], m, dtype, mode)
    cap0 = ours._cap
    for s in range(900, 1400, 125):
        ours.append(T[s : s + 125])
        ref.append(T[s : s + 125])
    assert ours._cap == 2 * cap0 and ours.capacity_doublings == 1
    MP, MPI = ours.profile()
    assert MP.dtype == np.float64 and MPI.dtype == np.int32 and MP.shape == (1400 - m + 1,)
    MPr, MPIr = ref.profile()
    assert_profile_close(T, m, MP, MPI, MPr, MPIr, EPS[dtype])
    # the float64 batch: windows without a neighbor (-1) hold the sentinel
    # of their own dtype
    MPb, MPIb = _batch(T, m, mode)
    none = MPIb < 0
    np.testing.assert_array_equal(MPI[none], -1)
    assert_profile_close(T, m, np.where(none, MPb, MP), MPI, MPb, MPIb, EPS[dtype])
    np.testing.assert_array_equal(ours.series, T)


def test_single_point_appends_equal_the_batch_profile():
    T = _walk(400, 6)
    m = 16
    smp = StreamingMatrixProfile(T[:380], m, "float64", device="cpu")
    for x in T[380:]:
        smp.append([x])
    smp.append([])
    MPb, MPIb = _batch(T, m, "full")
    assert_profile_close(T, m, *smp.profile(), MPb, MPIb, 1e-8)


def test_trim_head_matches_mpx_and_the_batch_of_the_retained_series():
    T = _walk(1800, 7)
    m = 16
    ours = StreamingMatrixProfile(T[:700], m, "float64", "right", device="cpu")
    ref = MpxStreaming(T[:700], m, "float64", "right")
    for s in range(700, 1800, 220):
        ours.append(T[s : s + 220])
        ref.append(T[s : s + 220])
        if ours.series.shape[0] > 1200:
            drop = ours.series.shape[0] - 900
            ours.trim_head(drop)
            ref.trim_head(drop)
    assert ours.offset == ref.offset > 0
    kept = T[ours.offset :]
    np.testing.assert_array_equal(ours.series, kept)
    MP, MPI = ours.profile()
    assert_profile_close(kept, m, MP, MPI, *ref.profile(), 1e-8)
    assert_profile_close(kept, m, MP, MPI, *_batch(kept, m, "right"), 1e-8)
    np.testing.assert_allclose(ours.row_values(10, 50), MP[10:50], rtol=0, atol=0)


def test_staged_elements_are_o_of_k_per_append():
    T = _walk(1400, 8)
    m = 16
    smp = StreamingMatrixProfile(T[:1300], m, "float32", device="cpu")
    per_append = []
    for s in range(1300, 1400, 10):
        before = smp.staged_elements
        smp.append(T[s : s + 10])
        per_append.append(smp.staged_elements - before)
    assert max(per_append) <= 3 * 10 + m  # O(k + m), never the series


@pytest.mark.parametrize("mode", ["full", "left"])
def test_trim_head_is_refused_outside_right(mode):
    smp = StreamingMatrixProfile(_walk(200, 9), 16, "float64", mode, device="cpu")
    with pytest.raises(ValueError, match="mode='right'"):
        smp.trim_head(10)


def test_refusals():
    T = _walk(200, 10)
    with pytest.raises(ValueError, match="mode"):
        StreamingMatrixProfile(T, 16, mode="both", device="cpu")
    with pytest.raises(ValueError, match="too short"):
        StreamingMatrixProfile(T[:19], 16, device="cpu")
    smp = StreamingMatrixProfile(T, 16, "float64", "right", device="cpu")
    with pytest.raises(ValueError, match="fewer than"):
        smp.trim_head(190)
