"""FSE (Finite State Entropy / tANS) tables — build, decode, encode, and the
table-description (NCount) wire format, per RFC 8878 §4.1.

Role parity: the FSE half of the entropy machinery inside the reference's
vendored zstd (used by every compressed block the reference reads/writes via
ZSTD_decompressDCtx / ZSTD_compressCCtx, lib/zpack_read.c:380,
lib/zpack_write.c:179).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import CompressError, DecompressError
from .bits import BackwardBitWriter, ForwardBitReader, highbit

FSE_MAX_ACCURACY = 9  # sequence tables cap (LL/ML 9, OF 8 enforced by callers)


# ---------------------------------------------------------------------------
# NCount (normalized count) wire format
# ---------------------------------------------------------------------------


def read_ncount(
    data: bytes, offset: int, max_symbol: int, max_al: int = FSE_MAX_ACCURACY
) -> tuple[list[int], int, int]:
    """Parse an FSE table description starting at ``offset``.

    Returns (normalized_counts, accuracy_log, bytes_consumed).  Counts use
    the zstd convention: -1 = "less than 1" probability, 0 = absent.
    ``max_al`` is the per-context accuracy cap (LL 9 / OF 8 / ML 9 /
    Huffman-weights 6, RFC 8878 §3.1.1.3.2.1.1 & §4.2.1.2).
    """
    br = ForwardBitReader(data, offset)
    al = br.read(4) + 5
    if al > max_al:
        raise DecompressError(f"FSE accuracy log {al} exceeds cap {max_al}")
    remaining = (1 << al) + 1
    threshold = 1 << al
    nbits = al + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1:
        if len(counts) > max_symbol:
            raise DecompressError("FSE table has too many symbols")
        if previous0:
            # zero-run: 2-bit groups, value 3 = continue
            while br.peek(2) == 3:
                br.skip(2)
                counts.extend([0, 0, 0])
            n0 = br.read(2)
            counts.extend([0] * n0)
            if len(counts) > max_symbol + 1:
                raise DecompressError("FSE zero run overruns symbol range")
        maxv = (2 * threshold - 1) - remaining
        val = br.peek(nbits)
        if (val & (threshold - 1)) < maxv:
            val &= threshold - 1
            br.skip(nbits - 1)
        else:
            br.skip(nbits)
            if val >= threshold:
                val -= maxv
        count = val - 1  # -1 = low-probability marker
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold and remaining > 1:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise DecompressError("FSE table description does not sum to table size")
    return counts, al, br.byte_pos - offset


def write_ncount(counts: list[int], al: int) -> bytes:
    """Emit an FSE table description (inverse of :func:`read_ncount`)."""
    table_size = 1 << al
    acc = 0
    accbits = 0
    out = bytearray()

    def emit(value: int, nbits: int):
        nonlocal acc, accbits
        acc |= (value & ((1 << nbits) - 1)) << accbits
        accbits += nbits
        while accbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            accbits -= 8

    emit(al - 5, 4)
    remaining = table_size + 1
    threshold = table_size
    nbits = al + 1
    i = 0
    previous0 = False
    while remaining > 1:
        if i >= len(counts):
            raise CompressError("FSE counts do not sum to table size")
        if previous0:
            start = i
            while i < len(counts) and counts[i] == 0:
                i += 1
            run = i - start
            while run >= 3:
                emit(3, 2)
                run -= 3
            emit(run, 2)
            if i >= len(counts):
                raise CompressError("FSE counts end in zero run")
        c = counts[i]
        i += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -c if c < 0 else c
        val = c + 1
        if val >= threshold:
            val += maxv
        if val < maxv:
            emit(val, nbits - 1)
        else:
            emit(val, nbits)
        previous0 = c == 0
        while remaining < threshold and remaining > 1:
            nbits -= 1
            threshold >>= 1
    if accbits:
        out.append(acc & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode tables
# ---------------------------------------------------------------------------


@dataclass
class DecodeTable:
    al: int
    symbols: np.ndarray  # (size,) uint16 — symbol per state
    nb_bits: np.ndarray  # (size,) uint8  — bits to read on transition
    new_state: np.ndarray  # (size,) uint16 — transition base


def _spread_symbols(counts: list[int], al: int) -> np.ndarray:
    size = 1 << al
    symbols = np.zeros(size, dtype=np.uint16)
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise DecompressError("FSE table spread did not return to zero")
    return symbols


def build_decode_table(counts: list[int], al: int) -> DecodeTable:
    size = 1 << al
    symbols = _spread_symbols(counts, al)
    next_count = [1 if c == -1 else c for c in counts]
    nb_bits = np.zeros(size, dtype=np.uint8)
    new_state = np.zeros(size, dtype=np.uint16)
    for t in range(size):
        s = int(symbols[t])
        x = next_count[s]
        next_count[s] = x + 1
        nb = al - highbit(x)
        nb_bits[t] = nb
        new_state[t] = (x << nb) - size
    return DecodeTable(al, symbols, nb_bits, new_state)


def build_rle_table(symbol: int) -> DecodeTable:
    """Degenerate 1-state table for RLE symbol mode (RFC 8878 mode 1)."""
    return DecodeTable(
        0,
        np.array([symbol], dtype=np.uint16),
        np.zeros(1, dtype=np.uint8),
        np.zeros(1, dtype=np.uint16),
    )


# ---------------------------------------------------------------------------
# Encode tables
# ---------------------------------------------------------------------------


@dataclass
class EncodeTable:
    al: int
    state_table: np.ndarray  # (size,) uint16 — next-state numbers (size + u)
    delta_nb_bits: np.ndarray  # per symbol
    delta_find_state: np.ndarray  # per symbol
    counts: list[int]

    def init_state(self, symbol: int) -> int:
        nb = (int(self.delta_nb_bits[symbol]) + (1 << 15)) >> 16
        val = (nb << 16) - int(self.delta_nb_bits[symbol])
        return int(self.state_table[(val >> nb) + int(self.delta_find_state[symbol])])

    def encode(self, writer: BackwardBitWriter, state: int, symbol: int) -> int:
        nb = (state + int(self.delta_nb_bits[symbol])) >> 16
        writer.add(state, nb)
        return int(self.state_table[(state >> nb) + int(self.delta_find_state[symbol])])

    def flush(self, writer: BackwardBitWriter, state: int) -> None:
        writer.add(state, self.al)


def build_encode_table(counts: list[int], al: int) -> EncodeTable:
    size = 1 << al
    symbols = _spread_symbols(counts, al)
    cumul = np.zeros(len(counts) + 1, dtype=np.int64)
    total = 0
    for s, c in enumerate(counts):
        cumul[s] = total
        total += 1 if c == -1 else max(c, 0)
    state_table = np.zeros(size, dtype=np.uint16)
    fill = cumul.copy()
    # low-prob symbols occupy the top cells in _spread_symbols; iterate all
    # cells and hand each state number to its symbol's next slot
    for u in range(size):
        s = int(symbols[u])
        state_table[fill[s]] = size + u
        fill[s] += 1
    delta_nb = np.zeros(len(counts), dtype=np.int64)
    delta_fs = np.zeros(len(counts), dtype=np.int64)
    total = 0
    for s, c in enumerate(counts):
        if c == 0:
            delta_nb[s] = ((al + 1) << 16) - (1 << al)
            delta_fs[s] = 0
        elif c == -1 or c == 1:
            delta_nb[s] = (al << 16) - (1 << al)
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits = al - highbit(c - 1)
            delta_nb[s] = (max_bits << 16) - (c << max_bits)
            delta_fs[s] = total - c
            total += c
    return EncodeTable(al, state_table, delta_nb, delta_fs, list(counts))


# ---------------------------------------------------------------------------
# Histogram normalization (encoder side)
# ---------------------------------------------------------------------------


def normalize_counts(hist: np.ndarray, al: int, total: int) -> list[int]:
    """Normalize a histogram to sum to 2^al, using -1 for rare symbols.

    A simplified FSE_normalizeCount: proportional scaling, rare symbols
    pinned to -1, rounding error absorbed by the most frequent symbol.
    """
    size = 1 << al
    if total <= 0:
        raise CompressError("empty histogram")
    norm = [0] * len(hist)
    distributed = 0
    largest = -1
    largest_count = -1
    for s, c in enumerate(hist):
        c = int(c)
        if c == 0:
            continue
        if c == total:
            raise CompressError("single-symbol histogram should use RLE mode")
        scaled = c * size // total
        if scaled == 0:
            norm[s] = -1
            distributed += 1
        else:
            norm[s] = scaled
            distributed += scaled
        if c > largest_count:
            largest_count = c
            largest = s
    rest = size - distributed
    if rest < 0:
        # over-distributed (can happen via the -1 pins): shave from largest
        if norm[largest] + rest < 1:
            raise CompressError("FSE normalization failed")
        norm[largest] += rest
    else:
        norm[largest] += rest
    if norm[largest] < 1:
        raise CompressError("FSE normalization failed")
    return norm


def optimal_accuracy_log(total: int, max_symbol: int, cap: int) -> int:
    """Heuristic accuracy log (FSE_optimalTableLog shape): enough states to
    distinguish symbols, bounded by input size and the format cap."""
    if total <= 1:
        return 5
    al = highbit(total - 1) - 2
    al = max(al, highbit(max_symbol) + 2 if max_symbol else 5)
    return max(5, min(al, cap))
