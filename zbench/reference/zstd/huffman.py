"""Huffman coding for zstd literals (RFC 8878 §4.2).

Role parity: the HUF_* half of the reference's vendored zstd entropy stack.

The decoder is *parallel-first*: instead of a sequential bit-by-bit walk, it
precomputes, for every bit position in the (backward) stream, the decoded
symbol and next position — all with vectorized table gathers — then extracts
the actual decode path by pointer-doubling (orbit enumeration).  That is the
same massively-parallel decompression formulation used by GPU
decompressors in the literature.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import CompressError, DecompressError
from .bits import BackwardBitReader, BackwardBitWriter, highbit
from . import fse

MAX_BITS = 11  # zstd huffman code length limit (RFC 8878 §4.2.1)
WEIGHT_FSE_AL_MAX = 6


@dataclass
class HuffDecodeTable:
    max_bits: int
    symbols: np.ndarray  # (2^max_bits,) uint8
    nb_bits: np.ndarray  # (2^max_bits,) uint8


@dataclass
class HuffEncodeTable:
    max_bits: int
    codes: np.ndarray  # (256,) uint16
    lengths: np.ndarray  # (256,) uint8
    weights: list[int]  # per symbol 0..max_symbol-1 (last implied weight excluded)


# ---------------------------------------------------------------------------
# Weights wire format
# ---------------------------------------------------------------------------


def read_weights(data: bytes, offset: int) -> tuple[list[int], int]:
    """Parse the Huffman tree description.  Returns (weights incl. the
    implied last symbol, bytes consumed)."""
    if offset >= len(data):
        raise DecompressError("missing huffman tree header")
    header = data[offset]
    if header < 128:
        # FSE-compressed weights: two interleaved states over a shared table
        csize = header
        payload = data[offset + 1 : offset + 1 + csize]
        if len(payload) < csize:
            raise DecompressError("truncated huffman weight payload")
        counts, al, desc = fse.read_ncount(payload, 0, 255, WEIGHT_FSE_AL_MAX)
        table = fse.build_decode_table(counts, al)
        br = BackwardBitReader(payload[desc:])
        even = br.read(table.al)
        odd = br.read(table.al)
        weights: list[int] = []
        # Interleaved 2-state decode; a state's symbol is emitted, then the
        # partner state emits one final symbol when the stream under-runs
        # (mirrors FSE_decompress_usingDTable's termination, RFC 8878
        # §4.2.1.2).
        while len(weights) <= 255:
            weights.append(int(table.symbols[even]))
            bits = int(table.nb_bits[even])
            if br.bits_left < bits:
                weights.append(int(table.symbols[odd]))
                break
            even = int(table.new_state[even]) + br.read(bits)
            weights.append(int(table.symbols[odd]))
            bits = int(table.nb_bits[odd])
            if br.bits_left < bits:
                weights.append(int(table.symbols[even]))
                break
            odd = int(table.new_state[odd]) + br.read(bits)
        else:
            raise DecompressError("too many huffman weights")
        consumed = 1 + csize
    else:
        n = header - 127
        nbytes = (n + 1) // 2
        payload = data[offset + 1 : offset + 1 + nbytes]
        if len(payload) < nbytes:
            raise DecompressError("truncated huffman weights")
        weights = []
        for i in range(n):
            b = payload[i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        consumed = 1 + nbytes
    # derive the implied last weight
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    if total == 0:
        raise DecompressError("empty huffman weights")
    next_pow2 = 1 << (highbit(total) + 1)
    rest = next_pow2 - total
    if rest & (rest - 1):
        raise DecompressError("huffman weights do not complete a power of two")
    weights.append(highbit(rest) + 1)
    max_bits = highbit(next_pow2)
    if max_bits > MAX_BITS:
        raise DecompressError("huffman code length exceeds 11 bits")
    return weights, consumed


def write_weights(weights: list[int]) -> bytes:
    """Emit a tree description.  ``weights`` excludes the implied last
    symbol.  Uses FSE compression when it wins, else the direct format."""
    n = len(weights)
    direct = None
    if n <= 128:
        direct = bytearray([127 + n])
        for i in range(0, n, 2):
            hi = weights[i] << 4
            lo = weights[i + 1] if i + 1 < n else 0
            direct.append(hi | lo)
    fse_enc = _write_weights_fse(weights)
    if fse_enc is not None and (direct is None or len(fse_enc) < len(direct)):
        return bytes(fse_enc)
    if direct is None:
        raise CompressError("cannot emit >128 weights without FSE")
    return bytes(direct)


def _write_weights_fse(weights: list[int]) -> bytes | None:
    hist = np.bincount(np.array(weights, dtype=np.int64), minlength=1)
    total = len(weights)
    nonzero = np.count_nonzero(hist)
    if nonzero < 2 or total < 2:
        return None
    al = min(fse.optimal_accuracy_log(total, len(hist) - 1, WEIGHT_FSE_AL_MAX), WEIGHT_FSE_AL_MAX)
    try:
        counts = fse.normalize_counts(hist, al, total)
    except CompressError:
        return None
    if len(weights) < 2:
        return None
    table = fse.build_encode_table(counts, al)
    desc = fse.write_ncount(counts, al)
    w = BackwardBitWriter()
    # Two interleaved chains (decoder alternates even/odd); FSE encodes each
    # chain backward: init on the chain's last symbol, then encode earlier
    # symbols, finally flush — odd first so the decoder's first read (last
    # written) is the even chain's initial state.
    state_even: int | None = None
    state_odd: int | None = None
    for i in range(len(weights) - 1, -1, -1):
        sym = weights[i]
        if i % 2 == 0:
            state_even = table.init_state(sym) if state_even is None else table.encode(w, state_even, sym)
        else:
            state_odd = table.init_state(sym) if state_odd is None else table.encode(w, state_odd, sym)
    table.flush(w, state_odd)
    table.flush(w, state_even)
    payload = desc + w.finish()
    if len(payload) >= 128:
        return None
    return bytearray([len(payload)]) + bytearray(payload)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def build_decode_table(weights: list[int]) -> HuffDecodeTable:
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    max_bits = highbit(total)
    if (1 << max_bits) != total:
        raise DecompressError("huffman weights not a power of two")
    size = 1 << max_bits
    symbols = np.zeros(size, dtype=np.uint8)
    nb_bits = np.zeros(size, dtype=np.uint8)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                length = 1 << (w - 1)
                symbols[pos : pos + length] = s
                nb_bits[pos : pos + length] = max_bits + 1 - w
                pos += length
    if pos != size:
        raise DecompressError("huffman table underfilled")
    return HuffDecodeTable(max_bits, symbols, nb_bits)


def _stream_bit_windows(payload: bytes, max_bits: int) -> np.ndarray:
    """For every bit position p in the backward stream, the value of bits
    [p-max_bits, p) — i.e. what a decoder positioned at p would peek.
    Index 0 is the start of the buffer; positions below max_bits zero-pad
    (matching the reference's defined little-end fill)."""
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8), bitorder="little")
    n = len(bits)
    padded = np.concatenate([np.zeros(max_bits, dtype=np.uint8), bits])
    win = np.zeros(n + 1, dtype=np.uint32)
    for k in range(max_bits):
        win |= padded[k : k + n + 1].astype(np.uint32) << np.uint32(k)
    return win  # win[p] = bits [p-max_bits, p) as an integer, LSB = lowest bit


def _decode_one_stream(payload: bytes, table: HuffDecodeTable, n_symbols: int) -> np.ndarray:
    """Vectorized single-stream Huffman decode via orbit doubling."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    if not payload:
        raise DecompressError("empty huffman stream")
    last = payload[-1]
    if last == 0:
        raise DecompressError("huffman stream missing sentinel")
    start = (len(payload) - 1) * 8 + (last.bit_length() - 1)
    win = _stream_bit_windows(payload, table.max_bits)
    # peek at position p = win[p]; decoded symbol/nbbits via table gather
    sym_at = table.symbols[win]
    nb_at = table.nb_bits[win].astype(np.int64)
    nxt = np.arange(len(win), dtype=np.int64) - nb_at
    np.clip(nxt, 0, None, out=nxt)
    # orbit of `start` under nxt, enumerated by doubling concatenation
    positions = np.array([start], dtype=np.int64)
    jump = nxt
    while len(positions) < n_symbols:
        positions = np.concatenate([positions, jump[positions]])
        jump = jump[jump]
    positions = positions[:n_symbols]
    out = sym_at[positions]
    # validity: the final position must land exactly on 0 bits remaining
    final_bits = int(positions[-1]) - int(nb_at[positions[-1]])
    if final_bits != 0:
        raise DecompressError("huffman stream not fully consumed")
    return out


def decode_1stream(payload: bytes, table: HuffDecodeTable, regen_size: int) -> bytes:
    return _decode_one_stream(payload, table, regen_size).tobytes()


def decode_4stream(payload: bytes, table: HuffDecodeTable, regen_size: int) -> bytes:
    if len(payload) < 6:
        raise DecompressError("4-stream literals too short for jump table")
    s1 = int.from_bytes(payload[0:2], "little")
    s2 = int.from_bytes(payload[2:4], "little")
    s3 = int.from_bytes(payload[4:6], "little")
    body = payload[6:]
    if s1 + s2 + s3 > len(body):
        raise DecompressError("jump table overruns literals payload")
    streams = [
        body[:s1],
        body[s1 : s1 + s2],
        body[s1 + s2 : s1 + s2 + s3],
        body[s1 + s2 + s3 :],
    ]
    per = (regen_size + 3) // 4
    sizes = [per, per, per, regen_size - 3 * per]
    if sizes[3] < 0:
        raise DecompressError("regenerated size smaller than 3 stream quarters")
    outs = [_decode_one_stream(s, table, n) for s, n in zip(streams, sizes)]
    return np.concatenate(outs).tobytes()


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def build_encode_table(hist: np.ndarray) -> HuffEncodeTable | None:
    """Histogram → canonical length-limited Huffman code.

    Returns None when a table is pointless (single symbol).  Code lengths
    are limited to MAX_BITS with a simple overflow-redistribution pass."""
    present = np.flatnonzero(hist)
    if len(present) < 2:
        return None
    max_symbol = int(present[-1])
    lengths = _package_merge_lengths(hist[: max_symbol + 1], MAX_BITS)
    max_len = int(lengths[present].max())
    # weights: w = max_len + 1 - length for coded symbols
    weights_full = np.where(lengths > 0, max_len + 1 - lengths, 0)
    codes, lengths = _canonical_codes(weights_full, max_len)
    table = HuffEncodeTable(
        max_bits=max_len,
        codes=codes,
        lengths=lengths,
        weights=[int(w) for w in weights_full[:max_symbol]],
    )
    return table


def _package_merge_lengths(hist: np.ndarray, limit: int) -> np.ndarray:
    """Length-limited code lengths via the package-merge algorithm
    (optimal under the limit)."""
    syms = np.flatnonzero(hist)
    freqs = hist[syms].astype(np.int64)
    n = len(syms)
    lengths = np.zeros(len(hist), dtype=np.int64)
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if n > (1 << limit):
        raise CompressError("alphabet too large for code length limit")
    # package-merge: limit-1 package steps, each re-merged with the items;
    # code length of a symbol = its occurrence count among the first 2n-2
    # nodes of the final merged list
    items = sorted((int(f), (int(s),)) for s, f in zip(syms, freqs))
    merged = list(items)
    for _ in range(limit - 1):
        packages = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
        merged = sorted(items + packages)
    for _, group in merged[: 2 * n - 2]:
        for s in group:
            lengths[s] += 1
    return lengths


def _canonical_codes(weights_full: np.ndarray, max_len: int):
    """Assign zstd-canonical codes: table filled by increasing weight
    (longest codes first), natural symbol order within a weight."""
    lengths = np.where(weights_full > 0, max_len + 1 - weights_full, 0).astype(np.uint8)
    codes = np.zeros(len(weights_full), dtype=np.uint16)
    pos = 0
    for w in range(1, max_len + 1):
        for s in np.flatnonzero(weights_full == w):
            length = 1 << (w - 1)
            # code value = range start >> (weight-1)
            codes[s] = pos >> (w - 1)
            pos += length
    return codes, lengths


def _encode_stream(data: np.ndarray, table: HuffEncodeTable) -> bytes:
    """Encode one stream, fully vectorized: symbols are laid out from last
    to first (so the backward-reading decoder recovers them in order), each
    code OR-ed into a 32-bit-word bit plane at its cumulative offset."""
    lens = table.lengths[data].astype(np.int64)
    if (lens == 0).any():
        raise CompressError("symbol without code in huffman encode")
    vals = table.codes[data].astype(np.uint64)
    rev_vals = vals[::-1]
    rev_lens = lens[::-1]
    offsets = np.concatenate([[0], np.cumsum(rev_lens)[:-1]])
    total_bits = int(rev_lens.sum())
    nwords = (total_bits + 1) // 32 + 3
    acc = np.zeros(nwords, dtype=np.uint64)
    idx = (offsets >> 5).astype(np.int64)
    sh = (offsets & 31).astype(np.uint64)
    np.bitwise_or.at(acc, idx, rev_vals << sh)  # codes ≤ 11 bits: fit in 32+11
    # fold the high halves into the next word's low bits
    acc[1:] |= acc[:-1] >> np.uint64(32)
    acc &= np.uint64(0xFFFFFFFF)
    # sentinel closing bit
    acc[total_bits >> 5] |= np.uint64(1) << np.uint64(total_bits & 31)
    out = acc.astype("<u4").tobytes()
    nbytes = (total_bits + 1 + 7) // 8
    return out[:nbytes]


def encode_4stream(data: bytes, table: HuffEncodeTable) -> bytes | None:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    per = (n + 3) // 4
    parts = [arr[:per], arr[per : 2 * per], arr[2 * per : 3 * per], arr[3 * per :]]
    if any(len(p) == 0 for p in parts):
        return None
    encoded = [_encode_stream(p, table) for p in parts]
    if any(len(e) > 0xFFFF for e in encoded[:3]):
        return None
    out = bytearray()
    out += len(encoded[0]).to_bytes(2, "little")
    out += len(encoded[1]).to_bytes(2, "little")
    out += len(encoded[2]).to_bytes(2, "little")
    for e in encoded:
        out += e
    return bytes(out)


def encode_1stream(data: bytes, table: HuffEncodeTable) -> bytes:
    return _encode_stream(np.frombuffer(data, dtype=np.uint8), table)
