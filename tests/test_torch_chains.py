"""Time series chains of mpx_torch (``mpx_torch.chains``, on the CPU)
against mpx's.

The host functions are index-chasing over two int32 arrays, so both
packages get the same arrays and must agree exactly.  ``compute_chains``
runs each package's left/right profile: in float64 on a random walk
(no equidistant neighbors) the indices, and with them the chains, agree
exactly; in float32 the port's left/right indices equal its own driver's.
"""

import numpy as np
import pytest

import mpx
import mpx.chains as mpx_chains
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch import chains
from tests.conftest import random_walk

M = 32


def _cfg(dtype="float64"):
    return MatrixProfileConfig(m=M, dtype=dtype, band=256, chunk=512, device="cpu")


def _left_right(T):
    out = compute_matrix_profile(T, config=_cfg(), left_right=True)
    return out[1].numpy(), out[3].numpy()


@pytest.fixture(scope="module")
def walk():
    return random_walk(2048, seed=41)


def test_host_functions_equal_mpxs(walk):
    il, ir = _left_right(walk)
    np.testing.assert_array_equal(chains.chain_links(il, ir), mpx_chains.chain_links(il, ir))
    lengths = chains.chain_lengths(il, ir)
    np.testing.assert_array_equal(lengths, mpx_chains.chain_lengths(il, ir))
    assert lengths.max() >= 3
    for anchor in (0, int(lengths.argmax()), il.shape[0] - 1):
        np.testing.assert_array_equal(chains.anchored_chain(il, ir, anchor),
                                      mpx_chains.anchored_chain(il, ir, anchor))
    for min_length in (2, 3):
        ours = chains.all_chains(il, ir, min_length=min_length)
        ref = mpx_chains.all_chains(il, ir, min_length=min_length)
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_chain_lengths_by_doubling_match_walking(walk):
    il, ir = _left_right(walk)
    lengths = chains.chain_lengths(il, ir)
    for i in range(0, il.shape[0], 97):
        assert lengths[i] == chains.anchored_chain(il, ir, i).shape[0]


@pytest.mark.parametrize("anchor", [None, 100])
def test_compute_chains_equals_mpxs_f64(walk, anchor):
    ours = chains.compute_chains(walk, _cfg(), anchor=anchor)
    ref = mpx_chains.compute_chains(walk, mpx.MatrixProfileConfig(
        m=M, dtype="float64", band=256, chunk=512), anchor=anchor)
    np.testing.assert_array_equal(ours.mpi_left, ref.mpi_left)
    np.testing.assert_array_equal(ours.mpi_right, ref.mpi_right)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    np.testing.assert_array_equal(ours.chain, ref.chain)
    assert ours.length == ref.length
    if anchor is not None:
        assert ours.chain[0] == anchor


def test_compute_chains_reads_the_drivers_left_right_f32(walk):
    res = chains.compute_chains(walk, _cfg("float32"))
    out = compute_matrix_profile(walk, config=_cfg("float32"), left_right=True)
    np.testing.assert_array_equal(res.mpi_left, out[1].numpy())
    np.testing.assert_array_equal(res.mpi_right, out[3].numpy())
    np.testing.assert_array_equal(res.chain, chains.anchored_chain(
        res.mpi_left, res.mpi_right, int(res.lengths.argmax())))


def test_refusals_match_mpxs():
    il = np.array([-1, 0, 1, 2], np.int32)
    ir = np.array([1, 2, 3, -1], np.int32)
    for mod in (chains, mpx_chains):
        with pytest.raises(ValueError, match="swap"):
            mod.chain_links(ir, il)
        with pytest.raises(ValueError, match="equal-length"):
            mod.chain_links(il, ir[:3])
        with pytest.raises(ValueError, match="out of range"):
            mod.anchored_chain(il, ir, 4)
    np.testing.assert_array_equal(chains.anchored_chain(il, ir, 0), [0, 1, 2, 3])
    with pytest.raises(ValueError, match="conflicts"):
        chains.compute_chains(np.arange(100.0), _cfg(), m=16)
