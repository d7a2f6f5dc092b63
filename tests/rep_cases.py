"""Repeat-offset blocks at the edges of the CUDA scan's warp and tile lengths:
one definition for the CPU tests (plain versions against the JAX scan and a
sequential state machine) and the GPU tests (kernels against plain).
Imports nothing of jax."""

import numpy as np

from zpack_tpu_torch.kernels import fse_torch

_TILE = fse_torch.REP_TILE
REP_EDGE_LENGTHS = [0, 1, 31, 32, 33, _TILE - 1, _TILE, _TILE + 1, 2 * _TILE, 12000]


def rep_edge_case(lengths, underflow: str, seed: int = 9):
    """Blocks of the given lengths with random maps (45% new offsets, 30%
    zero literal lengths); ``underflow`` "first" makes every block's first
    sequence resolve r0 - 1 = 0 from the entry state (1, 4, 8), "last" makes
    its last one do so after a new offset of 1.  Returns flat int32 arrays
    ovs, lls, mls, the int64 seq_off and the (B, 3) entry states."""
    rng = np.random.default_rng(seed)
    nsq = np.array(lengths, np.int64)
    total = int(nsq.sum())
    ovs = np.where(rng.random(total) < 0.55, rng.integers(1, 4, total),
                   rng.integers(4, 70000, total)).astype(np.int32)
    lls = np.where(rng.random(total) < 0.3, 0, rng.integers(1, 50, total)).astype(np.int32)
    mls = rng.integers(3, 300, total).astype(np.int32)
    seq_off = np.concatenate([[0], np.cumsum(nsq)]).astype(np.int64)
    base = 0 if underflow == "first" else 100000
    for b, n in enumerate(nsq):
        lo, hi = int(seq_off[b]), int(seq_off[b + 1])
        if underflow == "first" and n >= 1:
            ovs[lo], lls[lo] = 3, 0
        if underflow == "last" and n >= 2:
            ovs[hi - 2] = 4              # r0 = 1
            ovs[hi - 1], lls[hi - 1] = 3, 0  # r0 - 1 = 0
    entry = np.tile(np.array([1, 4, 8], np.int32) + base, (len(nsq), 1))
    return ovs, lls, mls, seq_off, entry
