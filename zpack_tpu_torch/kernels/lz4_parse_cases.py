"""LZ4 blocks that stress the block parse (``lz4_torch.parse_batch`` and
its plain version ``lz4_torch.build_batch``): literal and match lengths on
both sides of the token's nibble and of every extension byte, 65,535-long
runs, a literal-only last sequence and a block of one token, sequences at
the count bound, truncation inside every field, the two bad offsets, a block
over its declared size, a parse error in a later block beside a size error
in an earlier one, a row longer than the CUDA parse stages in shared memory
(``lz4_torch.PARSE_STAGE_CAP``), and mixed batches of all of them.

The CUDA walk reads a row in two steps: a walker that follows the token
chain without loading an offset, then the whole CTA reading the values and
checking the offsets.  So the cases also hold what the deferred checks make
hard: an offset error followed, later in the row, by a chain error, by a
literal overrun or by garbage that would send a walker far; a zero offset
on a token whose match length is truncated; an offset error past the first
tile of 256 sequences; and many tiny and empty rows beside rows at and
above the stage cap, for the packing of rows into CTAs.

:func:`cases` is the one definition; the CPU tests hold ``build_batch``
against the JAX package, the host decoder and a numpy statement of the
CUDA parse's two passes on it, and the GPU tests and ``chip_smoke.py`` hold
the kernel against ``build_batch`` on the same batches.

A case is one batch: the blocks, their declared sizes, and ``expect``, the
``DecompressError`` message the batch must raise (None: it parses).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs.lz4 import block as lz4block
from .lz4_torch import PARSE_STAGE_CAP


class Case(NamedTuple):
    blocks: list
    sizes: list
    expect: str | None


def _ext(n: int) -> bytes:
    """The extension bytes of a length whose nibble is 15: ``n`` is what
    remains after the nibble (255 runs, then the rest)."""
    return b"\xff" * (n // 255) + bytes([n % 255])


def encode(seqs, last: bytes = b"") -> bytes:
    """An LZ4 block from ``(literals, offset, match_len)`` sequences and the
    last literal run; the offsets are not checked."""
    out = bytearray()
    for lits, off, ml in seqs:
        ll, mc = len(lits), ml - 4
        out.append(min(ll, 15) << 4 | min(mc, 15))
        if ll >= 15:
            out += _ext(ll - 15)
        out += lits
        out += off.to_bytes(2, "little")
        if mc >= 15:
            out += _ext(mc - 15)
    ll = len(last)
    out.append(min(ll, 15) << 4)
    if ll >= 15:
        out += _ext(ll - 15)
    out += last
    return bytes(out)


def _decoded_size(blk: bytes) -> int:
    return len(lz4block.decompress_block(blk, 1 << 24))


def _valid(blocks: list) -> Case:
    return Case(blocks, [_decoded_size(b) for b in blocks], None)


EDGES = (14, 15, 16, 269, 270, 271)


def _edge_blocks(rng) -> list:
    """Every literal length of :data:`EDGES` beside every match length of
    them and of them plus 4 (the match nibble counts from 4)."""
    lits = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    seqs = [(lits[:8], 8, 8)]
    for ll in EDGES:
        for ml in EDGES + tuple(e + 4 for e in EDGES):
            seqs.append((lits[:ll], int(rng.integers(1, 9)), ml))
    seqs += [(b"", 1, ml) for ml in (4, 18, 19, 20)]
    return [encode(seqs, lits[:ll]) for ll in (0, 14, 15, 16, 269, 270, 271)]


def _long_runs(rng) -> list:
    """Matches of 65,535 and 65,539 (code 65,535), with literal runs between."""
    lits = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return [encode([(lits[:5], 5, 65535), (lits[:1], 65535, 65539), (b"", 3, 65535)], lits),
            encode([(lits[:1], 1, 65535 + 4)])]


def _at_bound(k: int) -> bytes:
    """A literal, then ``k`` sequences of the least size (a token and an
    offset), then a one-byte last token: ``seq_bound`` sequences exactly."""
    return encode([(b"a", 1, 4)] + [(b"", 1 + i % 3 if i > 3 else 1, 4) for i in range(k)])


def _corpus_blocks(rng) -> list:
    """Prose, 32-byte records, noise and runs, compressed by the host encoder."""
    words = [b"archive ", b"the ", b"stream ", b"of ", b"entropy ", b"block "]
    prose = b"".join(words[i] for i in rng.integers(0, len(words), 4000))[:16384]
    rec = np.zeros((1024, 32), np.uint8)
    rec[:, 0] = 0x7F
    rec[:, 1:5] = (np.arange(1024)[:, None] >> np.arange(4) * 8).astype(np.uint8)
    rec[:, 5:12] = rng.integers(0, 4, (1024, 7))
    noise = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    raws = [prose, rec.tobytes(), noise, b"z" * 20000 + prose[:3000], b"", b"q"]
    return [lz4block.compress_block(r) for r in raws]


def _above_cap(rng) -> bytes:
    """A row longer than the stage: a 65,535-byte literal run, then random
    short sequences, some 190 KB of compressed bytes in all."""
    lits = rng.integers(0, 256, 65535, dtype=np.uint8).tobytes()
    seqs = [(lits, 1000, 20)]
    out = 65535 + 20
    while len(seqs) < 22000:
        ll = int(rng.integers(0, 6))
        seqs.append((lits[:ll], int(rng.integers(1, min(out + ll, 65535) + 1)),
                     int(rng.integers(4, 13))))
        out += ll + seqs[-1][2]
    blk = encode(seqs, lits[:7])
    assert PARSE_STAGE_CAP < len(blk) < 256 << 10
    return blk


def _past_tile(off: int) -> bytes:
    """300 good sequences, a sequence with offset ``off`` (0, or beyond the
    output) at index 300, past the first tile, then a truncated offset."""
    return encode([(b"a", 1, 4)] * 300 + [(b"b", off, 4)]) + b"\xf0"


def _exact(n: int, rng) -> bytes:
    """A block of exactly ``n`` bytes: 2,000 random short sequences, then
    one literal run (one more short sequence where no run length fits)."""
    lits = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    seqs, out = [(lits[:4], 4, 8)], 12
    while len(seqs) < 2000:
        ll = int(rng.integers(0, 6))
        seqs.append((lits[:ll], int(rng.integers(1, min(out + ll, 65535) + 1)),
                     int(rng.integers(4, 13))))
        out += ll + seqs[-1][2]
    while True:
        head = encode(seqs)[:-1]  # without its empty last token
        r = n - len(head)
        for ll in range(max(r - 3 - r // 255, 0), r):
            tail = encode([], lits[:ll])
            if len(tail) == r:
                return head + tail
        seqs.append((lits[:1], 1, 4))


def _tiny_rows(rng) -> list:
    """250 rows of 0 to about 40 bytes, the empty and one-token blocks among
    them, and a block of exactly the stage cap and one a byte above it."""
    lits = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    rows = []
    for i in range(250):
        seqs = [(lits[:int(rng.integers(1, 5))], 1, int(rng.integers(4, 20)))
                for _ in range(int(rng.integers(0, 4)))]
        rows.append((b"", b"\x00", b"\x10a")[i] if i < 3 else
                    encode(seqs, lits[:int(rng.integers(0, 20))]))
    at, above = _exact(PARSE_STAGE_CAP, rng), _exact(PARSE_STAGE_CAP + 1, rng)
    assert (len(at), len(above)) == (PARSE_STAGE_CAP, PARSE_STAGE_CAP + 1)
    return rows[:120] + [at] + rows[120:] + [above]


#: one truncated or malformed block per error, with the message it raises
BAD = {
    "truncated literal length": [b"\xf0", b"\xf0\xff", b"\xf0\xff\xff"],
    "literal run overruns input": [b"\x50abc", b"\xf0\x00" + b"x" * 14],
    "truncated match offset": [b"\x11a\x01", encode([(b"ab", 1, 4)])[:4]],
    "zero match offset": [b"\x10a\x00\x00\x00",
                          b"\x10a\x00\x00\xf0",  # then a truncated literal length
                          b"\x1fa\x00\x00",  # not its truncated match length
                          b"\x10a\x00\x00" + b"\xff" * 3000,  # then a long garbage run
                          _past_tile(0)],
    "match offset beyond output start": [bytes([0x10, 0x61, 0x05, 0x00, 0x50]) + b"bcdef",
                                         encode([(b"abc", 4, 4)]),
                                         bytes([0x10, 0x61, 0x05, 0x00, 0x50]) + b"bc",
                                         bytes([0x10, 0x61, 0x05, 0x00]) + b"\xff" * 3000,
                                         _past_tile(60000)],
    "truncated match length": [b"\x1fa\x01\x00", b"\x1fa\x01\x00\xff",
                               encode([(b"ab", 1, 4)])[:-1] + b"\x1fa\x01\x00\xff\xff"],
}


def cases(seed: int = 0) -> dict:
    """name -> Case.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    out["nibble and extension edges"] = _valid(_edge_blocks(rng))
    out["65,535-long matches"] = _valid(_long_runs(rng))
    # a block of one token, literal-only last sequences of one and two
    # bytes, a block that ends right after a match, and an empty block
    out["one token, literal-only last, no last literals, empty"] = _valid(
        [b"\x00", b"\x10a", encode([(b"abcd", 4, 9)], b"xy"),
         encode([(b"abcd", 4, 9)])[:-1], b""])
    out["sequences at the count bound"] = _valid([_at_bound(k) for k in (0, 1, 2, 2700)])
    out["corpus blocks"] = _valid(_corpus_blocks(rng))
    out["a row above the stage cap"] = _valid([_above_cap(rng), _corpus_blocks(rng)[0]])
    good = _corpus_blocks(rng)[:2]
    for msg, blocks in BAD.items():
        for i, blk in enumerate(blocks):
            # the bad block after good ones, so the row it is in matters
            out[f"{msg} ({i})"] = Case(good + [blk], [1 << 16] * 3, msg)
    sizes = [_decoded_size(b) for b in good]
    out["block over its declared size"] = Case(good, [sizes[0], sizes[1] - 1], (
        "block output exceeds declared size"))
    out["declared size exactly"] = Case(good, sizes, None)
    out["parse error later beside a size error earlier"] = Case(
        good + [b"\x10a\x00\x00\x00"], [sizes[0] - 1, sizes[1], 100], "zero match offset")
    # deferred offset checks beside a chain error at the same sequence or in
    # another row (the host decoder's walk checks the offset's reach last)
    out["offset beyond on a truncated match length"] = Case(
        good + [b"\x1fa\x05\x00"], [1 << 16] * 3, "match offset beyond output start")
    out["a chain error in a row before an offset error in a later one"] = Case(
        good + [b"\x10a\x01", b"\x10a\x00\x00\x00"], [1 << 16] * 4, "truncated match offset")
    out["an offset error in a row before a chain error in a later one"] = Case(
        good + [_past_tile(60000), b"\xf0\xff"], [1 << 16] * 4,
        "match offset beyond output start")
    # every valid block above in one batch, then every block of every case
    valid = [b for c in out.values() if c.expect is None for b in c.blocks]
    out["mixed: every valid block"] = _valid(valid)
    out["mixed: tiny and empty rows, rows at and above the stage cap"] = _valid(_tiny_rows(rng))
    everything = [(b, s) for c in list(out.values()) for b, s in zip(c.blocks, c.sizes)]
    first_bad = next(msg for msg in BAD)  # the first bad block in order raises
    out["mixed: every block"] = Case([b for b, _ in everything], [s for _, s in everything],
                                     first_bad)
    return out
