"""LZ4 *block* codec — independent implementation of the public LZ4 block
format (token / literals / 16-bit offset / LSIC lengths).

Role parity: the block layer underneath the reference's LZ4F_* calls
(reference: lib/zpack_write.c:204-211, lib/zpack_read.c:414-439 delegate to
the lz4 library; the ZPack spec mandates the frame format on disk,
docs/specs.md:101 — frames are built on these blocks in frame.py).

Match finding and parsing use the shared parallel-first matcher
(zpack_tpu.codecs.match): output is valid LZ4 (decodable by any conformant
decoder) but not byte-identical to liblz4's choices — the format permits
this and the archive contract only requires spec-valid frames at ≤ the
reference's compressed size.
"""

from __future__ import annotations

import numpy as np

from ... import native
from ...errors import DecompressError
from .. import match as M

MIN_MATCH = 4
MFLIMIT = 12  # matches must not start within the last 12 bytes
LAST_LITERALS = 5  # last 5 bytes are always literals
MAX_OFFSET = 65535


def compress_bound(size: int) -> int:
    """Worst-case LZ4 block output (LZ4_compressBound formula)."""
    return size + size // 255 + 16


def _write_lsic(out: bytearray, value: int) -> None:
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)


def compress_block(data: bytes, level: int = 1) -> bytes:
    """Compress one LZ4 block.  ``level`` maps to hash-chain search depth
    (1-2 → depth 2, higher levels search deeper like the HC modes).

    Fast levels route through the native C++ greedy encoder when available;
    higher levels (and any environment without the toolchain) use the
    numpy parallel-first matcher below."""
    data = bytes(data)
    comp = native.lz4_compress_block(data, level)
    if comp is not None:
        return comp
    b = np.frombuffer(data, dtype=np.uint8)
    n = len(b)
    out = bytearray()
    if n == 0:
        return b""
    if n < MFLIMIT + 1:
        _emit_sequence(out, data, 0, n, None, None)
        return bytes(out)

    depth = 2 if level <= 2 else min(1 << min(level - 1, 6), 64)
    src, mlen = M.find_matches(b, depth, MAX_OFFSET, hash_bits=16)
    mps, mss, mls = [], [], []
    for lit_start, lit_len, p, j, ml in M.greedy_parse(
        b, src, mlen, match_limit=n - MFLIMIT, end_limit=n - LAST_LITERALS,
        lazy=level >= 3,
    ):
        if p is not None:
            mps.append(p)
            mss.append(j)
            mls.append(ml)
    return serialize_sequences_np(
        data, np.array(mps, np.int64), np.array(mss, np.int64), np.array(mls, np.int64)
    )


def _emit_sequence(out: bytearray, data: bytes, lit_off: int, lit_len: int,
                   offset: int | None, match_len: int | None) -> None:
    if offset is None:
        token = min(lit_len, 15) << 4
        out.append(token)
        if lit_len >= 15:
            _write_lsic(out, lit_len - 15)
        out += data[lit_off : lit_off + lit_len]
        return
    ml_code = match_len - MIN_MATCH
    token = (min(lit_len, 15) << 4) | min(ml_code, 15)
    out.append(token)
    if lit_len >= 15:
        _write_lsic(out, lit_len - 15)
    out += data[lit_off : lit_off + lit_len]
    out.append(offset & 0xFF)
    out.append((offset >> 8) & 0xFF)
    if ml_code >= 15:
        _write_lsic(out, ml_code - 15)


def decompress_block(data: bytes, max_out: int | None = None,
                     prefix: bytes = b"") -> bytes:
    """Decode one LZ4 block.  ``prefix`` supplies history for linked-block
    frames (matches may reach back into previously decoded blocks).

    Sequence replay runs one python step per *sequence* with C-speed slice
    copies; overlapping matches replicate their period via bytes repetition.
    Routes through the native C++ decoder when available and the output
    bound is known.
    """
    if max_out is not None:
        out = native.lz4_decompress_block(bytes(data), max_out, bytes(prefix))
        if out is not None:
            return out
    src = bytes(data)
    n = len(src)
    out = bytearray(prefix)
    base = len(prefix)
    pos = 0
    while pos < n:
        token = src[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated literal length")
                c = src[pos]
                pos += 1
                lit_len += c
                if c != 255:
                    break
        if pos + lit_len > n:
            raise DecompressError("literal run overruns input")
        out += src[pos : pos + lit_len]
        pos += lit_len
        if pos == n:
            break  # last sequence: literals only
        if pos + 2 > n:
            raise DecompressError("truncated match offset")
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0:
            raise DecompressError("zero match offset")
        match_len = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated match length")
                c = src[pos]
                pos += 1
                match_len += c
                if c != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise DecompressError("match offset beyond output start")
        if offset >= match_len:
            out += out[start : start + match_len]
        else:
            pattern = out[start:]
            reps = match_len // offset + 1
            out += (bytes(pattern) * reps)[:match_len]
        if max_out is not None and len(out) - base > max_out:
            raise DecompressError("output exceeds declared size")
    return bytes(out[base:])


# ---------------------------------------------------------------------------
# Vectorized sequence serialization
# ---------------------------------------------------------------------------


def serialize_sequences_np(data: bytes, match_pos: np.ndarray, match_src: np.ndarray,
                           match_len: np.ndarray) -> bytes:
    """Assemble an LZ4 block from parsed match events, fully vectorized
    (tokens/LSIC/offsets scattered, literals copied via ragged index maps).

    ``match_pos`` must be sorted ascending and non-overlapping; literal
    runs are the gaps between matches, with the final gap emitted as the
    terminating literal-only sequence.
    """
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    mp = np.asarray(match_pos, dtype=np.int64)
    ms = np.asarray(match_src, dtype=np.int64)
    ml = np.asarray(match_len, dtype=np.int64)
    nseq = len(mp)

    prev_end = np.concatenate([[0], mp + ml])  # literal run starts
    lit_start = prev_end[:-1]
    lit_len = mp - lit_start
    final_lit_start = int(prev_end[-1])
    final_lit_len = n - final_lit_start
    off = mp - ms

    # per-sequence LSIC lengths
    lit_ex = np.maximum(lit_len - 15, -1)  # -1 → no LSIC
    lit_lsic = np.where(lit_len >= 15, lit_ex // 255 + 1, 0)
    ml_code = ml - MIN_MATCH
    ml_ex = np.maximum(ml_code - 15, -1)
    ml_lsic = np.where(ml_code >= 15, ml_ex // 255 + 1, 0)

    seq_len = 1 + lit_lsic + lit_len + 2 + ml_lsic
    final_lsic = (final_lit_len - 15) // 255 + 1 if final_lit_len >= 15 else 0
    total = int(seq_len.sum()) + 1 + final_lsic + final_lit_len

    out = np.zeros(total, dtype=np.uint8)
    dst = np.concatenate([[0], np.cumsum(seq_len)])
    dst_start = dst[:-1]

    # tokens
    tok = (np.minimum(lit_len, 15) << 4) | np.minimum(ml_code, 15)
    out[dst_start] = tok

    # literal LSIC runs
    _scatter_lsic(out, dst_start + 1, lit_lsic, lit_ex)
    # literals (ragged copy)
    lit_dst = dst_start + 1 + lit_lsic
    _ragged_copy(out, arr, lit_dst, lit_start, lit_len)
    # offsets
    off_dst = lit_dst + lit_len
    out[off_dst] = off & 0xFF
    out[off_dst + 1] = (off >> 8) & 0xFF
    # match LSIC runs
    _scatter_lsic(out, off_dst + 2, ml_lsic, ml_ex)

    # final literal-only sequence
    p = int(dst[-1])
    out[p] = min(final_lit_len, 15) << 4
    if final_lsic:
        _scatter_lsic(out, np.array([p + 1]), np.array([final_lsic]),
                      np.array([final_lit_len - 15]))
    fl_dst = p + 1 + final_lsic
    out[fl_dst : fl_dst + final_lit_len] = arr[final_lit_start:n]
    return out.tobytes()


def _scatter_lsic(out: np.ndarray, dst: np.ndarray, lsic_len: np.ndarray,
                  extra: np.ndarray) -> None:
    """Write LSIC length byte runs (255,255,...,rem) at ragged positions."""
    sel = np.flatnonzero(lsic_len > 0)
    if not len(sel):
        return
    lens = lsic_len[sel]
    seq_of = np.repeat(np.arange(len(sel)), lens)
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    within = np.arange(int(lens.sum())) - starts[seq_of]
    n255 = lens - 1
    vals = np.where(within < n255[seq_of], 255, extra[sel][seq_of] % 255)
    # value layout: n255 bytes of 255 then remainder = extra - 255*n255
    rem = extra[sel] - 255 * n255
    vals = np.where(within < n255[seq_of], 255, rem[seq_of])
    out[dst[sel][seq_of] + within] = vals


def _ragged_copy(out: np.ndarray, src_arr: np.ndarray, dst: np.ndarray,
                 src: np.ndarray, lens: np.ndarray) -> None:
    sel = np.flatnonzero(lens > 0)
    if not len(sel):
        return
    lens_s = lens[sel]
    seq_of = np.repeat(np.arange(len(sel)), lens_s)
    starts = np.concatenate([[0], np.cumsum(lens_s)])[:-1]
    within = np.arange(int(lens_s.sum())) - starts[seq_of]
    out[dst[sel][seq_of] + within] = src_arr[src[sel][seq_of] + within]
