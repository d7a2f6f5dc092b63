"""Replay batches that stress the sequence replay (``lz4_torch.replay``):
copy chains as deep as a row, sources at the edges of 32-sequence chunks,
segments at the edges of the kernel's 1,024-byte tiles and 4-byte threads,
literal-only and empty segments, every row shape in one batch.

:func:`cases` is the one definition; the CPU tests hold ``replay_plain``
against :func:`replay_bytewise` on it, and the GPU tests and
``chip_smoke.py`` hold the kernel against ``replay_plain`` on the same
batches.  A batch has the layout of ``lz4_torch.build_batch``, but ``S``
and ``n_out`` are the largest row's, as on the zstd path, not a bucket.

A row is a list of segments ``(lit_len, offset, match_len)``: ``lit_len``
literal bytes, then ``match_len`` bytes copied from ``offset`` back.  A
segment with ``match_len == 0`` carries offset 0 (zstd's literal-only
segments, LZ4's last one).  Every offset is valid: it reaches no further
back than the row's start.
"""

from __future__ import annotations

import numpy as np

CHUNK = 32  # sequence counts are taken on both sides of a warp's width
TILE = 1024  # output bytes a tile of the CUDA kernel, four a thread


def _pack(rows: list, rng, pad_rows: int = 0, extra_s: int = 0) -> dict:
    """Rows of segments into one batch; the literals are random bytes."""
    bp = len(rows) + pad_rows
    S = max(max((len(r) for r in rows), default=0), 1) + extra_s
    lit_total = [sum(ll for ll, _, _ in r) for r in rows]
    L = max(max(lit_total, default=0), 1)
    batch = {
        "lit_bytes": np.zeros((bp, L), np.uint8),
        "seg_start": np.zeros((bp, S), np.int32),
        "lit_start": np.zeros((bp, S), np.int32),
        "lit_len": np.zeros((bp, S), np.int32),
        "offset": np.zeros((bp, S), np.int32),
        "n_seq": np.zeros(bp, np.int32),
        "out_len": np.zeros(bp, np.int32),
    }
    for i, r in enumerate(rows):
        k = len(r)
        if not k:
            continue
        lls, offs, mls = (np.array(x, np.int64) for x in zip(*r))
        seg_len = lls + mls
        st = np.cumsum(seg_len) - seg_len
        if not ((mls == 0) | ((offs > 0) & (offs <= st + lls))).all():
            raise ValueError("a match offset reaches before its row")
        batch["seg_start"][i, :k] = st
        batch["lit_start"][i, :k] = np.cumsum(lls) - lls
        batch["lit_len"][i, :k] = lls
        batch["offset"][i, :k] = offs
        batch["n_seq"][i] = k
        batch["out_len"][i] = seg_len.sum()
        batch["lit_bytes"][i, : lit_total[i]] = rng.integers(0, 256, lit_total[i], dtype=np.uint8)
    batch["n_out"] = max(int(batch["out_len"].max()), 1)
    return batch


def _random_row(rng, n: int, near: float = 0.5, max_ll: int = 12, max_ml: int = 40,
                lit_only: float = 0.0) -> list:
    """``n`` segments after a 64-byte literal head: a share ``near`` of the
    matches reads the last 64 bytes, the others anywhere behind; a share
    ``lit_only`` of the segments is literal-only (offset 0)."""
    row, pos = [(64, 0, 0)], 64
    for _ in range(n - 1):
        ll = int(rng.integers(0, max_ll + 1))
        if rng.random() < lit_only:
            row.append((ll + 1, 0, 0))
            pos += ll + 1
            continue
        ml = int(rng.integers(3, max_ml + 1))
        m0 = pos + ll
        o = int(rng.integers(1, min(m0, 64) + 1)) if rng.random() < near \
            else int(rng.integers(1, m0 + 1))
        row.append((ll, o, ml))
        pos = m0 + ml
    return row


def cases(seed: int = 0) -> dict:
    """name -> batch.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}

    # every match reads all of the match before it, for the whole row; and
    # the same with a literal between, so the source ends one short of m0
    out["chain"] = _pack([
        [(8, 0, 0)] + [(0, 8, 8)] * 3000,
        [(7, 0, 0)] + [(1, 8, 7)] * 2500,
        [(5, 0, 0)] + [(0, 5, 5)] * 100 + [(3, 0, 0)],
    ], rng, pad_rows=5)

    # offset-1 runs over several chunks of sequences, each reading the byte
    # just written; one match of offset 1 that spans several tiles
    out["offset-1 runs"] = _pack([
        [(1, 0, 0)] + [(0, 1, 5)] * 200 + [(2, 1, 3)] * 100,
        [(1, 1, 5000), (4, 1, 3), (0, 2, 700)],
    ], rng, pad_rows=1)

    # the row's last matches read its first bytes
    head = [(300, 0, 0)]
    body = _random_row(rng, 400, near=0.7)
    pos = 300 + sum(ll + ml for ll, _, ml in body)
    tail = []
    for i in range(70):
        tail.append((1, pos + 1 - (i % 37), 20))
        pos += 21
    out["reach back to the row's start"] = _pack([head + body + tail], rng, pad_rows=2)

    # a source that straddles the edge between two chunks of 32 sequences, a
    # source that ends exactly at m0 (offset == match_len), one that starts
    # at a chunk's first byte and one that ends at its last
    row = [(4, 0, 0)] + [(2, 3, 4)] * 31  # chunk 0: 32 segments, 4 + 31 * 6 = 190 bytes
    edge = 190
    row += [(0, 10, 20)]            # reads [180, 200): 10 bytes of chunk 0, then itself
    row += [(1, 21 + 5, 10)]        # m0 = 211, reads [185, 195): straddles the edge
    row += [(0, 10, 10)]            # ends at m0: reads the match just before it
    row += [(3, 234 - edge, 6)]     # m0 = 234, starts at chunk 1's first byte
    row += [(0, 240 - (edge - 7), 7)]  # m0 = 240, ends at chunk 0's last byte
    row += [(2, 3, 4)] * 40
    out["sources at chunk edges"] = _pack([row, _random_row(rng, 100, near=1.0)], rng)

    # zstd rows: literal-only segments (offset 0) between the sequences
    out["literal-only segments mixed in"] = _pack([
        _random_row(rng, 700, lit_only=0.3),
        [(5, 0, 0), (3, 0, 0), (0, 8, 8), (9, 0, 0)] * 50,
        [(40, 0, 0)],
    ], rng, pad_rows=1, extra_s=3)

    # long matches: offset below and above the length, a period that does
    # not divide the length, a source far behind
    out["long matches"] = _pack([
        [(50, 0, 0), (0, 7, 129), (2, 181, 128), (0, 1, 1000), (5, 300, 300), (1, 33, 5000),
         (0, 5000, 4999), (3, 2, 127)] + _random_row(rng, 60, max_ml=600)[1:],
        _random_row(rng, 200, near=0.3, max_ml=400),
    ], rng, pad_rows=3)

    # sequence counts at the chunk's edges, and S no multiple of 32
    out["sequence counts 0, 1, 31, 32, 33, 70"] = _pack(
        [_random_row(rng, n, near=0.8) if n else [] for n in (0, 1, 31, 32, 33, 70)],
        rng, pad_rows=2, extra_s=5)

    # segments at the edges of the kernel's tiles of 1,024 bytes and threads
    # of 4: a match that ends at a tile's last byte, one that starts at its
    # first, a literal run across the edge, an empty segment, and runs of
    # segments of 1 to 3 bytes (several inside one thread's 4 bytes)
    row = [(TILE - 4, 0, 0), (0, 5, 4), (0, TILE, 8), (0, 0, 0), (1, 0, 0), (1, 0, 0)]
    row += [(0, 2, 1), (1, 0, 0), (0, 3, 2), (0, 0, 0), (2, 1, 1)] * 150
    row += [(TILE // 2, 0, 0), (3, TILE, TILE + 3)]
    out["tile and thread edges"] = _pack([
        row, _random_row(rng, 1500, near=0.9, max_ll=2, max_ml=4),
    ], rng, pad_rows=1)

    # rows under and over 64 KiB in one batch, with padding rows
    out["rows under and over 64 KiB"] = _pack([
        _random_row(rng, 9000, near=0.6),         # about 240 KB
        _random_row(rng, 300, near=0.9),
        [(70000, 0, 0), (0, 70000, 70000)],
        _random_row(rng, 2500, near=0.2, max_ll=3, max_ml=8),
    ], rng, pad_rows=4)
    return out


def replay_bytewise(batch: dict) -> np.ndarray:
    """The batch executed one byte at a time in Python: (bp, n_out) uint8,
    zero past each row's ``out_len``."""
    bp = len(batch["n_seq"])
    out = np.zeros((bp, batch["n_out"]), np.uint8)
    for i in range(bp):
        row = bytearray()
        lits = batch["lit_bytes"][i].tobytes()
        ns, total = int(batch["n_seq"][i]), int(batch["out_len"][i])
        for s in range(ns):
            if len(row) != batch["seg_start"][i, s]:
                raise ValueError(f"row {i}: segment {s} does not start where the last ended")
            l0, ll = int(batch["lit_start"][i, s]), int(batch["lit_len"][i, s])
            row += lits[l0:l0 + ll]
            end = int(batch["seg_start"][i, s + 1]) if s + 1 < ns else total
            o = int(batch["offset"][i, s])
            for _ in range(end - len(row)):
                row.append(row[-o])
        if len(row) != total:
            raise ValueError(f"row {i}: the segments do not add up to out_len")
        out[i, :total] = np.frombuffer(bytes(row), np.uint8)
    return out
