"""Literal-stream batches that stress the Huffman decode
(``huffman_torch.decode_streams``): every table width from 1 to 11 bits in
one launch (alphabets of 2 to 256 symbols), streams of no and of one
symbol, the over-read and unconsumed streams, tables shared by several
streams beside tables of their own, destinations with gaps, out of order
and past the output's end, the malformed rows, and a row longer than the
CUDA kernel stages in shared memory (``huffman_torch.STAGE_CAP``) among
1,000 short ones.

:func:`cases` is the one definition; the CPU tests hold
``decode_streams_plain`` against the JAX decoder, the host oracle
``huffman._decode_one_stream`` and a numpy statement of the CUDA kernel's
walk on it, and the GPU tests and ``chip_smoke.py`` hold the kernel against
``decode_streams_plain`` on the same batches.

A case is one batch of ``huffman_torch.build_decode_batch`` (rows edited
afterwards only in the malformed case), the streams it was built from,
each stream's symbols and what its row must decode to (:data:`EXPECT`).
Streams are written by ``huffman._encode_stream``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs.zstd import huffman as zhuf
from .huffman_torch import DECODE_COLS, STAGE_CAP, build_decode_batch

#: what a row must decode to: consumed exactly (final 0), over-read (final
#: < 0), not consumed (final > 0), no symbol at all (final 0), or a
#: malformed row (final -1, nothing written)
EXPECT = ("ok", "over-read", "unconsumed", "empty", "malformed")

#: the alphabet size of the table of each width 1..11
ALPHABETS = (2, 3, 5, 8, 13, 24, 40, 64, 100, 180, 256)


class Case(NamedTuple):
    batch: dict      # build_decode_batch's arrays, n_out and widest
    streams: list    # (payload, HuffDecodeTable, n_symbols) a row
    symbols: list    # each row's symbols as encoded (a uint8 array)
    expect: list     # a row's entry of EXPECT


def decode_table(et: zhuf.HuffEncodeTable) -> zhuf.HuffDecodeTable:
    """The decode table of a host encode table (its weights plus the
    implied last one)."""
    total = sum((1 << (w - 1)) for w in et.weights if w > 0)
    return zhuf.build_decode_table(et.weights + [((1 << total.bit_length()) - total).bit_length()])


def _lengths(max_bits: int, k: int) -> list[int]:
    """Code lengths of a complete prefix code of ``k`` symbols whose longest
    code has ``max_bits`` bits: lengths 1 .. max_bits - 1 and two of
    max_bits, then the deepest code shorter than max_bits split in two until
    there are ``k``."""
    if not max_bits + 1 <= k <= 1 << max_bits:
        raise ValueError(f"no complete code of {k} symbols has {max_bits} bits at most")
    lens = list(range(1, max_bits)) + [max_bits, max_bits]
    while len(lens) < k:
        i = max((i for i, n in enumerate(lens) if n < max_bits), key=lambda i: lens[i])
        lens[i:i + 1] = [lens[i] + 1] * 2
    return lens


def _table_of_width(rng, max_bits: int, repeats: int):
    """A stream of symbols with dyadic frequencies, so that the host encoder
    gives exactly the code of :func:`_lengths` (width ``max_bits``), and its
    encode and decode tables."""
    k = ALPHABETS[max_bits - 1]
    lens = np.array(_lengths(max_bits, k))
    counts = repeats << (max_bits - lens)  # 2^-len of the stream each
    data = rng.permutation(np.repeat(rng.permutation(k), counts)).astype(np.uint8)
    et = zhuf.build_encode_table(np.bincount(data, minlength=256))
    if et.max_bits != max_bits:
        raise AssertionError(f"table of width {et.max_bits}, not {max_bits}")
    return data, et, decode_table(et)


def _stream(rng, n: int, et) -> np.ndarray:
    """``n`` symbols drawn from the alphabet of ``et``, each with its code's
    probability."""
    lens = np.asarray(et.lengths, np.int64)
    syms = np.flatnonzero(lens)
    p = 0.5 ** lens[syms]
    return rng.choice(syms, size=n, p=p / p.sum()).astype(np.uint8)


def _case(rows: list, dst_off=None, n_out: int | None = None) -> Case:
    """Rows ``(symbols, encode table, decode table, n_symbols, expect)`` into
    a case: each stream encoded by the host (no symbol: the sentinel byte
    alone), decoding ``n_symbols``."""
    streams = [(zhuf._encode_stream(s, et) if len(s) else b"\x01", dt, n)
               for s, et, dt, n, _ in rows]
    batch = build_decode_batch([s[0] for s in streams], [s[1] for s in streams],
                               [s[2] for s in streams], dst_off)
    if n_out is not None:
        batch["n_out"] = n_out
    return Case(batch, streams, [r[0] for r in rows], [r[4] for r in rows])


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    widths = [_table_of_width(rng, m, max(1, 600 >> m)) for m in range(1, 12)]
    # every table width in one launch, each stream with a table of its own
    out["widths 1 to 11"] = _case([(d, et, dt, len(d), "ok") for d, et, dt in widths])
    # streams of one symbol and of none (the sentinel byte alone, and a whole
    # stream asked for no symbol); both lengths at the narrowest and widest
    # tables
    _, et1, dt1 = widths[0]
    _, et11, dt11 = widths[10]
    one1, one11 = _stream(rng, 1, et1), _stream(rng, 1, et11)
    long11 = _stream(rng, 700, et11)
    out["no and one symbol"] = _case([
        (one1, et1, dt1, 1, "ok"), (one11, et11, dt11, 1, "ok"),
        (one11[:0], et11, dt11, 0, "empty"), (long11, et11, dt11, 0, "empty"),
        (long11, et11, dt11, 700, "ok")])
    # decoding more symbols than a stream holds reads below bit 0 (zeros);
    # fewer leaves bits
    _, et6, dt6 = widths[5]
    s6 = _stream(rng, 900, et6)
    out["over-read and unconsumed"] = _case([
        (s6, et6, dt6, 900 + 37, "over-read"), (s6, et6, dt6, 900, "ok"),
        (s6, et6, dt6, 900 - 3, "unconsumed"), (s6[:5], et6, dt6, 5 + 1, "over-read"),
        (long11, et11, dt11, 700 + 1, "over-read")])
    # the four streams of a literal section share one table object (one
    # table row), beside streams with a table each
    _, et9, dt9 = widths[8]
    quad = [_stream(rng, n, et9) for n in (400, 400, 400, 397)]
    own = [_table_of_width(rng, m, 2) for m in (9, 11)]
    out["shared and own tables"] = _case(
        [(q, et9, dt9, len(q), "ok") for q in quad]
        + [(d, et, dt, len(d), "ok") for d, et, dt in own]
        + [(quad[1], et9, dt9, len(quad[1]), "ok")])
    # destinations: last stream first, gaps between them, the first stream
    # running past the end of the output and the last one starting before
    # its start
    placed = [_stream(rng, n, et) for n, (_, et, _) in zip((300, 41, 1000, 207), widths[3::2])]
    rows = [(s, et, dt, len(s), "ok") for s, (_, et, dt) in zip(placed, widths[3::2])]
    dst = [2500, 1800, 700, -200]
    out["placement"] = _case(rows, dst, n_out=2500 + 300 - 120)
    # the malformed rows, beside valid ones
    case = _case([(d, et, dt, len(d), "ok") for d, et, dt in widths] + [
        (d, et, dt, len(d), "malformed") for d, et, dt in widths[:9]])
    rows, T, P = case.batch["rows"], len(case.batch["tables"]), len(case.batch["payload"])
    edits = (("table", T), ("table", -1), ("max_bits", 0), ("max_bits", 12),
             ("n_bytes", P), ("byte_start", -1), ("start_bit", None), ("start_bit", -1),
             ("n_bytes", -1))
    for i, (col, v) in enumerate(edits):
        r = rows[11 + i]
        r[DECODE_COLS.index(col)] = 8 * r[1] if v is None else v  # start_bit at the row's end
    out["malformed"] = case
    # one row above the stage cap (256 symbols of 8 bits each) around 1,000
    # short streams over four shared tables
    et8 = zhuf.build_encode_table(np.ones(256, np.int64))
    dt8 = decode_table(et8)
    big = _stream(rng, STAGE_CAP + 1000, et8)
    short = []
    for i in range(1000):
        _, et, dt = widths[3 + i % 4]
        short.append((_stream(rng, int(rng.integers(1, 40)), et), et, dt))
    rows = [(s, et, dt, len(s), "ok") for s, et, dt in short]
    rows.insert(500, (big, et8, dt8, len(big), "ok"))
    case = _case(rows)
    if case.batch["widest"] <= STAGE_CAP:
        raise AssertionError("the row meant to exceed the stage cap does not")
    out["above the stage cap"] = case
    return out
