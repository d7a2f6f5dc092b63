"""Batches that stress the many-stream XXH3 kernel
(``xxh3_torch.accumulate_batch``): the edge lengths of the stripe and block
counts, one row of 512 KiB + 7, rows at the edges of the kernel's chunks of
28 blocks, overlapping rows in place, every kind of rejected row beside a
valid one, 1,000 short rows beside one of 1 MiB, and a batch of one row.

:func:`cases` is the one definition; the CPU tests hold
``hash_batch_plain`` against the JAX package's Pallas kernel (interpreted),
the host XXH3 and a numpy statement of the CUDA kernel's two steps (block
sums, then the chain) on it, and the GPU tests and ``chip_smoke.py`` hold
the kernel against ``hash_batch_plain`` on the same batches.

A case is one launch: ``flat`` (uint8) and ``rows`` ((n, 2) int64 of start,
length), with ``valid`` marking the rows the plain version takes.  A row it
rejects (not 8-aligned, 240 bytes or shorter, outside ``flat``, a negative
start) must read nothing on the card and yield zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs import xxh3 as H
from . import xxh3_torch

#: the lengths of ``chip_smoke.XXH3_EDGES``: stripe counts that are and are
#: not multiples of 16, the last stripe inside and across a block
EDGES = (241, 255, 256, 257, 1024, 1025, 1088, 1089, 16384, 16385, 65536)
#: 1 KiB blocks a chunk of the CUDA kernel holds (28 producer groups)
CHUNK_BLOCKS = 28


class Case(NamedTuple):
    flat: np.ndarray
    rows: np.ndarray
    valid: np.ndarray


def is_valid(flat_len: int, rows: np.ndarray) -> np.ndarray:
    """The rows the plain version takes (the kernel's rule)."""
    start, length = rows[:, 0], rows[:, 1]
    return ((length > H.MIDSIZE_MAX) & (start >= 0) & (start % 8 == 0)
            & (start <= flat_len - length))


def _case(flat: np.ndarray, rows) -> Case:
    rows = np.asarray(rows, np.int64).reshape(-1, 2)
    return Case(flat, rows, is_valid(len(flat), rows))


def _packed(streams: list) -> Case:
    """Streams packed as ``xxh3_64_batch`` packs them."""
    flat, offsets = xxh3_torch.split_packed(xxh3_torch.pack(streams), len(streams))
    return _case(flat.numpy().copy(), offsets.numpy().copy())


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def streams(case: Case) -> list:
    """The valid rows' bytes."""
    return [case.flat[s:s + n].tobytes() for (s, n), v in zip(case.rows.tolist(), case.valid)
            if v]


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    out["edge lengths"] = _packed([_bytes(rng, n) for n in EDGES])
    out["512 KiB + 7"] = _packed([_bytes(rng, (512 << 10) + 7)])
    # whole chunks and one block more or less, with and without a partial
    # block, the last stripe at every byte alignment of its word
    lengths = [64 * (16 * nb + rem) + 1 + (7 * nb + rem) % 64
               for nb in (CHUNK_BLOCKS - 1, CHUNK_BLOCKS, CHUNK_BLOCKS + 1,
                          2 * CHUNK_BLOCKS, 2 * CHUNK_BLOCKS + 1) for rem in (0, 15)]
    out["chunk edges"] = _packed([_bytes(rng, n) for n in lengths])
    # rows in one buffer where they lie: overlapping, 8-aligned but not 16
    raw = np.frombuffer(_bytes(rng, 50000), np.uint8).copy()
    out["overlapping rows in place"] = _case(
        raw, [[8, 1000], [16, 4000], [5000, 300], [96, 44000], [0, 50000], [49752, 241]])
    # each rejected kind beside a valid row
    raw = np.frombuffer(_bytes(rng, 5000), np.uint8).copy()
    out["rejected rows"] = _case(raw, [
        [0, 5000], [4, 1000],      # valid; not 8-aligned
        [8, 241], [0, 240],        # valid; 240 bytes (the short path)
        [4752, 248], [0, 0],       # valid, ending at the buffer's end; empty
        [16, 2000], [4096, 1000],  # valid; past the end
        [24, 4976], [-8, 1000],    # valid, the whole rest; a negative start
        [4000, 1000], [8, 5000]])  # valid; 8 bytes past the end
    # 1,000 short rows beside one of 1 MiB, in the middle of the batch
    short = [_bytes(rng, int(n)) for n in rng.integers(241, 2049, 1000)]
    out["short rows beside 1 MiB"] = _packed(short[:500] + [_bytes(rng, 1 << 20)] + short[500:])
    out["one row"] = _packed([_bytes(rng, 3000)])
    return out
