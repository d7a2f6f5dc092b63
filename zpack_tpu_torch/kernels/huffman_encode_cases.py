"""Literal batches that stress the Huffman stream encode
(``huffman_torch.encode_streams``): one-symbol streams, codes of 11 bits
and of 1 bit only, streams whose bits end on a word and one past it, stream
lengths at the edges of a load group (16 symbols) and of the CUDA kernel's
tile (16 symbols a thread, counted from the 16-byte boundary below a
stream's first symbol), a stream above 64 KiB, 4-stream blocks whose parts are
unequal, many tiny streams beside a long one, and tables shared by several
rows beside tables used once.

:func:`cases` is the one definition; the CPU tests hold the plain version
against the JAX encoder, the host oracle ``huffman._encode_stream`` and a
numpy statement of the CUDA kernel's tile walk on it, and the GPU tests and
``chip_smoke.py`` hold the kernel against ``encode_streams_plain`` on the
same batches.

A case is one call of ``TorchHuffmanEncoder``: ``encode_batch`` (streams,
a table each) or ``encode_4stream_batch`` (blocks of literals, a table
each).  :func:`batch` builds the kernel's batch of it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs.zstd import huffman
from . import huffman_torch

#: symbols one tile of the CUDA kernel covers: a CTA of 256 threads a
#: stream, 16 symbols a thread
TILE = 16 * 256


class Case(NamedTuple):
    method: str  # "encode_batch" or "encode_4stream_batch"
    items: list
    tables: list


def batch(case: Case) -> dict:
    """The kernel's batch of the case, as the encoder builds it."""
    if case.method == "encode_batch":
        return huffman_torch.build_batch(case.items, case.tables)
    return huffman_torch.build_4stream_batch(case.items, case.tables)[0]


def host_payloads(case: Case) -> list:
    """What the host oracle makes of the case."""
    if case.method == "encode_batch":
        return [huffman._encode_stream(np.asarray(s, np.uint8), t)
                for s, t in zip(case.items, case.tables)]
    return [huffman.encode_4stream(np.asarray(b, np.uint8).tobytes(), t)
            for b, t in zip(case.items, case.tables)]


def _table(hist) -> huffman.HuffEncodeTable:
    return huffman.build_encode_table(np.asarray(hist, np.int64))


def _coded(table) -> np.ndarray:
    return np.flatnonzero(table.lengths).astype(np.uint8)


def _draw(rng, table, n: int, lengths=None) -> np.ndarray:
    """n symbols the table codes (of the given code lengths only)."""
    pool = _coded(table)
    if lengths is not None:
        pool = pool[np.isin(table.lengths[pool], lengths)]
    return rng.choice(pool, n).astype(np.uint8)


def _skewed_table(rng, nsym: int = 256) -> huffman.HuffEncodeTable:
    """A table over nsym symbols with codes of many lengths, up to 11."""
    hist = np.zeros(256, np.int64)
    hist[:nsym] = np.maximum(1, (rng.pareto(0.7, nsym) * 50).astype(np.int64))
    return _table(hist)


def _eleven_bit_table() -> huffman.HuffEncodeTable:
    """Counts that halve from symbol to symbol: the length limit cuts the
    tail to 11-bit codes, many of them."""
    hist = np.zeros(256, np.int64)
    hist[:200] = np.maximum(1, (1 << 40) >> np.minimum(np.arange(200), 40))
    return _table(hist)


def _two_symbol_table() -> huffman.HuffEncodeTable:
    hist = np.zeros(256, np.int64)
    hist[[7, 200]] = [5, 3]
    return _table(hist)


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    two, eleven, wide = _two_symbol_table(), _eleven_bit_table(), _skewed_table(rng)
    assert set(two.lengths[_coded(two)]) == {1} and (eleven.lengths == 11).sum() > 50
    # one symbol a stream, under a 1-bit and an 11-bit table
    out["one symbol"] = Case("encode_batch", [_draw(rng, two, 1), _draw(rng, eleven, 1, [11]),
                                              _draw(rng, wide, 1)], [two, eleven, wide])
    # every code 11 bits: a field spans two words at most offsets
    out["all 11 bits"] = Case("encode_batch",
                              [_draw(rng, eleven, n, [11]) for n in (33, 700, TILE + 5)],
                              [eleven] * 3)
    # every code 1 bit: streams whose bits are their symbols, ending on a
    # word, one short of it and one past it, and on and beside one tile and
    # two
    lens = (31, 32, 33, 63, 64, 65, *(t + d for t in (TILE, 2 * TILE) for d in (-1, 0, 1)))
    out["all 1 bit, words and tiles"] = Case(
        "encode_batch", [_draw(rng, two, n) for n in lens], [two] * len(lens))
    # lengths at the edges of a load group and of a tile, each stream under
    # its own table (a CTA a row)
    lens = (1, 15, 16, 17, TILE - 1, TILE, TILE + 1)
    tabs = [_skewed_table(rng) for _ in lens]
    out["group and tile edges"] = Case("encode_batch",
                                       [_draw(rng, t, n) for t, n in zip(tabs, lens)], tabs)
    # bits that end exactly on a word, or one bit past it, in a stream one
    # tile long and a few symbols more: 9-bit codes, then 1-bit ones to
    # reach the word (a table with both lengths)
    mixed = _table(np.r_[[1 << 20], np.ones(255, np.int64)])
    ones, longs = _draw(rng, mixed, 4096, [1]), _draw(rng, mixed, 4096, [mixed.lengths.max()])
    ends = []
    for extra in (0, 1):
        s = np.concatenate([longs[:TILE - 64], ones[:64]])
        bits = int(mixed.lengths[s].astype(np.int64).sum())
        s = np.concatenate([s, ones[:(-bits) % 32 + extra]])
        ends.append(s)
    out["bits end on a word at a tile's end"] = Case("encode_batch", ends, [mixed] * 2)
    # a stream above 64 KiB beside a short one
    out["above 64 KiB"] = Case("encode_batch", [_draw(rng, wide, 70_001), _draw(rng, wide, 40)],
                               [wide] * 2)
    # 4-stream blocks (zstd's split: three parts of ceil(n / 4), the rest
    # last) whose last part is shorter (by 3 in 4 * 900 + 1), of 1 symbol
    # (13, 7) or one part each (4); blocks too short for four parts (5, 3);
    # parts at a tile and around it; tables each used by one block
    ns = (4, 5, 13, 4 * 900 + 1, 4 * TILE + 2, 4 * TILE - 3, 3, 7)
    tabs = [_skewed_table(rng) for _ in ns]
    out["4-stream uneven parts"] = Case("encode_4stream_batch",
                                        [_draw(rng, t, n) for t, n in zip(tabs, ns)], tabs)
    # the pattern 1, 1, 1, n - 3 in one CTA: four streams under one table,
    # back to back, as encode_batch lays them out
    n = 3 * TILE + 7
    out["1, 1, 1, n - 3 under one table"] = Case(
        "encode_batch", [_draw(rng, wide, k) for k in (1, 1, 1, n - 3)], [wide] * 4)
    # 4-stream blocks sharing one table object (runs longer than a CTA),
    # and a first part beyond 0xFFFF bytes (no 4-stream body)
    big = 4 * 48_000
    out["4-stream shared tables, a part too long"] = Case(
        "encode_4stream_batch",
        [_draw(rng, wide, 2000), _draw(rng, wide, 3001), _draw(rng, eleven, big, [11]),
         _draw(rng, wide, 64)], [wide, wide, eleven, wide])
    # 300 tiny streams beside one long one, tables mixed: shared by many
    # rows, by runs of rows and used once
    tiny, ttabs = [], []
    pool = [_skewed_table(rng, 40) for _ in range(3)]
    for i in range(300):
        t = pool[i % 3] if i % 5 else _skewed_table(rng, 20)
        tiny.append(_draw(rng, t, int(rng.integers(1, 4))))
        ttabs.append(t)
    tiny.insert(150, _draw(rng, wide, 20_000))
    ttabs.insert(150, wide)
    out["tiny streams beside a long one"] = Case("encode_batch", tiny, ttabs)
    return out
