"""Time series chains (ATSC / ALLC), counterpart of ``mpx/chains.py``.

A *time series chain* (Matrix Profile VII, Zhu et al., ICDM 2017) is a
temporally ordered sequence of windows in which every member is the
nearest neighbor of the one before it, in both directions.  Over the
left/right profile indices IL / IR (nearest strictly-earlier /
strictly-later neighbor of each window):

* windows ``i -> j`` with ``j = IR[i]`` are **bidirectionally linked**
  iff ``IL[j] == i``;
* the **anchored chain** ATSC(j) starts at j and follows right links
  while they remain bidirectional;
* the **all-chain set** ALLC partitions every window into maximal
  chains; its longest member is the *unanchored* chain.

The O(n^2) work is the left/right profile, computed by the port's driver
(``compute_matrix_profile(..., left_right=True)``: K1 on the card, the
hybrid by name); chain extraction is numpy index-chasing over two int32
arrays, with ALLC lengths by pointer doubling in O(w log L).
:mod:`mpx_torch.analysis`'s ``all_chains`` / ``unanchored_chain`` delegate
here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for


def chain_links(mpi_left, mpi_right) -> np.ndarray:
    """Per-window outgoing chain link: ``IR[i]`` where bidirectional.

    Returns int64 ``nxt`` with ``nxt[i] = IR[i]`` when the link
    ``i -> IR[i]`` is bidirectional (``IL[IR[i]] == i``), else -1.
    Sentinel (-1) left/right entries never link.
    """
    il = np.asarray(mpi_left, np.int64)
    ir = np.asarray(mpi_right, np.int64)
    if il.shape != ir.shape or il.ndim != 1:
        raise ValueError(
            f"mpi_left/mpi_right must be equal-length 1-D, got "
            f"{il.shape} vs {ir.shape}"
        )
    w = il.shape[0]
    if w and (ir.max() >= w or il.max() >= w):
        raise ValueError("profile index out of range")
    valid = ir >= 0
    # IL at the link target; sentinel targets stay invalid
    back = np.where(valid, il[np.where(valid, ir, 0)], -2)
    nxt = np.where(valid & (back == np.arange(w)), ir, -1)
    # right links must move forward in time; a violation means the
    # caller swapped the arguments
    bad = nxt[nxt >= 0] <= np.nonzero(nxt >= 0)[0]
    if bad.any():
        raise ValueError(
            "right profile index points backward - did you swap "
            "mpi_left and mpi_right?"
        )
    return nxt


def chain_lengths(mpi_left, mpi_right) -> np.ndarray:
    """ALLC chain length anchored at every window: ``lengths[i]`` is the
    number of windows on the chain starting at i (>= 1), by pointer
    doubling over the link graph (O(w log L), no per-element loop)."""
    nxt = chain_links(mpi_left, mpi_right)
    w = nxt.shape[0]
    if w == 0:
        return np.zeros(0, np.int64)
    valid = nxt >= 0
    # end[i]: furthest node reached so far; cnt[i]: edges from i to it.
    # Terminals are their own end with cnt 0, so squaring is idempotent
    # past convergence.
    end = np.where(valid, nxt, np.arange(w))
    cnt = valid.astype(np.int64)
    while (end[end] != end).any():
        cnt = cnt + cnt[end]
        end = end[end]
    return cnt + 1


def anchored_chain(mpi_left, mpi_right, anchor: int) -> np.ndarray:
    """ATSC: the chain anchored at ``anchor`` (always includes it)."""
    nxt = chain_links(mpi_left, mpi_right)
    w = nxt.shape[0]
    if not 0 <= anchor < w:
        raise ValueError(f"anchor {anchor} out of range [0, {w})")
    out = [anchor]
    i = anchor
    while nxt[i] >= 0:
        i = int(nxt[i])
        out.append(i)
    return np.asarray(out, np.int64)


@dataclass
class ChainsResult:
    """Longest unanchored chain plus the full ALLC length table."""

    chain: np.ndarray          # window indices of the longest chain
    lengths: np.ndarray        # ALLC length anchored at every window
    mpi_left: np.ndarray
    mpi_right: np.ndarray

    @property
    def length(self) -> int:
        return int(self.chain.shape[0])


def all_chains(mpi_left, mpi_right, min_length: int = 2):
    """The all-chain set: every maximal chain of >= ``min_length``.

    A chain head is a window with an outgoing link but no incoming
    bidirectional link.  Returns a list of int64 index arrays, longest
    first (ties: earlier head first).
    """
    nxt = chain_links(mpi_left, mpi_right)
    has_in = np.zeros(nxt.shape[0], bool)
    has_in[nxt[nxt >= 0]] = True
    heads = np.nonzero((nxt >= 0) & ~has_in)[0]
    chains = []
    for h in heads:
        c = [int(h)]
        i = int(h)
        while nxt[i] >= 0:
            i = int(nxt[i])
            c.append(i)
        if len(c) >= min_length:
            chains.append(np.asarray(c, np.int64))
    chains.sort(key=lambda c: (-len(c), c[0]))
    return chains


def compute_chains(
    T,
    config: Optional[MatrixProfileConfig] = None,
    *,
    m: Optional[int] = None,
    anchor: Optional[int] = None,
) -> ChainsResult:
    """Left/right profile on ``config.device``, then chain extraction on
    the host.  With ``anchor`` set, ``result.chain`` is the anchored chain
    ATSC(anchor); otherwise the longest unanchored chain."""
    from mpx_torch.driver import compute_matrix_profile

    config = config_for(m, config)
    _, mpil, _, mpir = compute_matrix_profile(T, config=config, left_right=True)
    mpil = mpil.cpu().numpy().astype(np.int64)
    mpir = mpir.cpu().numpy().astype(np.int64)
    lengths = chain_lengths(mpil, mpir)
    start = anchor if anchor is not None else int(lengths.argmax())
    chain = anchored_chain(mpil, mpir, start)
    return ChainsResult(chain=chain, lengths=lengths, mpi_left=mpil, mpi_right=mpir)
