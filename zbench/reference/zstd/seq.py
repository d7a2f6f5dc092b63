"""zstd sequences: code tables, section parse, FSE-interleaved bitstream
decode/encode, and sequence execution (RFC 8878 §3.1.1.3.2).

Role parity: the sequence half of compressed-block handling inside the
reference's vendored zstd (driven from lib/zpack_read.c:380 and
lib/zpack_write.c:179).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import CompressError, DecompressError
from .bits import BackwardBitReader, BackwardBitWriter
from . import fse

# --- code/value tables (RFC 8878 §3.1.1.3.2.1.1) ---------------------------

LL_CODE_MAX = 35
LL_BASELINES = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536,
]
LL_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]

ML_CODE_MAX = 52
ML_BASELINES = [
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539,
]
ML_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]

OF_CODE_MAX = 31

LL_DEFAULT_AL = 6
ML_DEFAULT_AL = 6
OF_DEFAULT_AL = 5
LL_MAX_AL = 9
ML_MAX_AL = 9
OF_MAX_AL = 8

# Predefined distributions (RFC 8878 §3.1.1.3.2.2)
LL_DEFAULT_DIST = [
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1,
]
ML_DEFAULT_DIST = [
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
]
OF_DEFAULT_DIST = [
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1,
]

_PREDEF_CACHE: dict[str, object] = {}


def predefined_decode_table(kind: str) -> fse.DecodeTable:
    key = f"dec_{kind}"
    if key not in _PREDEF_CACHE:
        dist, al = {
            "ll": (LL_DEFAULT_DIST, LL_DEFAULT_AL),
            "ml": (ML_DEFAULT_DIST, ML_DEFAULT_AL),
            "of": (OF_DEFAULT_DIST, OF_DEFAULT_AL),
        }[kind]
        _PREDEF_CACHE[key] = fse.build_decode_table(dist, al)
    return _PREDEF_CACHE[key]


def predefined_encode_table(kind: str) -> fse.EncodeTable:
    key = f"enc_{kind}"
    if key not in _PREDEF_CACHE:
        dist, al = {
            "ll": (LL_DEFAULT_DIST, LL_DEFAULT_AL),
            "ml": (ML_DEFAULT_DIST, ML_DEFAULT_AL),
            "of": (OF_DEFAULT_DIST, OF_DEFAULT_AL),
        }[kind]
        _PREDEF_CACHE[key] = fse.build_encode_table(dist, al)
    return _PREDEF_CACHE[key]


def ll_code(litlen: int) -> int:
    if litlen < 16:
        return litlen
    return 19 + (litlen.bit_length() - 1) if litlen > 63 else _LL_SMALL[litlen]


def ml_code(mlen: int) -> int:
    m = mlen - 3
    if m < 32:
        return m
    return 36 + (m.bit_length() - 1) if m > 127 else _ML_SMALL[m]


# small-value lookup tables mirroring the baseline rows above
_LL_SMALL = [0] * 64
for _c in range(LL_CODE_MAX + 1):
    _b, _n = LL_BASELINES[_c], LL_BITS[_c]
    for _v in range(_b, min(_b + (1 << _n), 64)):
        _LL_SMALL[_v] = _c
_ML_SMALL = [0] * 128
for _c in range(ML_CODE_MAX + 1):
    _b, _n = ML_BASELINES[_c] - 3, ML_BITS[_c]
    for _v in range(_b, min(_b + (1 << _n), 128)):
        _ML_SMALL[_v] = _c


@dataclass
class SequenceTables:
    """The three decode tables + repeat-mode bookkeeping carried across
    blocks in one frame (modes: 0 predefined / 1 RLE / 2 FSE / 3 repeat)."""

    ll: fse.DecodeTable | None = None
    of: fse.DecodeTable | None = None
    ml: fse.DecodeTable | None = None


def parse_nb_sequences(data: bytes, pos: int) -> tuple[int, int]:
    if pos >= len(data):
        raise DecompressError("missing sequence count")
    b0 = data[pos]
    if b0 < 128:
        return b0, pos + 1
    if b0 < 255:
        if pos + 2 > len(data):
            raise DecompressError("truncated sequence count")
        return ((b0 - 128) << 8) + data[pos + 1], pos + 2
    if pos + 3 > len(data):
        raise DecompressError("truncated sequence count")
    return data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3


def _read_table(data: bytes, pos: int, mode: int, kind: str, max_code: int,
                max_al: int, prev: fse.DecodeTable | None) -> tuple[fse.DecodeTable, int]:
    if mode == 0:
        return predefined_decode_table(kind), pos
    if mode == 1:
        if pos >= len(data):
            raise DecompressError("missing RLE symbol")
        sym = data[pos]
        if sym > max_code:
            raise DecompressError(f"RLE symbol {sym} out of range for {kind}")
        return fse.build_rle_table(sym), pos + 1
    if mode == 2:
        counts, al, consumed = fse.read_ncount(data, pos, max_code, max_al)
        return fse.build_decode_table(counts, al), pos + consumed
    if prev is None:
        raise DecompressError("repeat mode without previous table")
    return prev, pos


def decode_sequences(data: bytes, pos: int, tables: SequenceTables,
                     window_log_max: int = 31):
    """Parse a sequences section; returns (lit_lens, match_lens, offsets_raw,
    nb_seq) as numpy arrays, where offsets_raw is the *offset value* (before
    repeat-offset resolution, which depends on execution state)."""
    nb_seq, pos = parse_nb_sequences(data, pos)
    if nb_seq == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, 0
    if pos >= len(data):
        raise DecompressError("missing compression modes byte")
    modes = data[pos]
    pos += 1
    if modes & 0x3:
        raise DecompressError("reserved compression-mode bits set")
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3
    tables.ll, pos = _read_table(data, pos, ll_mode, "ll", LL_CODE_MAX, LL_MAX_AL, tables.ll)
    tables.of, pos = _read_table(data, pos, of_mode, "of", OF_CODE_MAX, OF_MAX_AL, tables.of)
    tables.ml, pos = _read_table(data, pos, ml_mode, "ml", ML_CODE_MAX, ML_MAX_AL, tables.ml)

    br = BackwardBitReader(data[pos:])
    llt, oft, mlt = tables.ll, tables.of, tables.ml
    ll_state = br.read(llt.al)
    of_state = br.read(oft.al)
    ml_state = br.read(mlt.al)

    lls = np.empty(nb_seq, dtype=np.int64)
    mls = np.empty(nb_seq, dtype=np.int64)
    ofs = np.empty(nb_seq, dtype=np.int64)
    ll_syms, ll_nb, ll_ns = llt.symbols, llt.nb_bits, llt.new_state
    of_syms, of_nb, of_ns = oft.symbols, oft.nb_bits, oft.new_state
    ml_syms, ml_nb, ml_ns = mlt.symbols, mlt.nb_bits, mlt.new_state
    read = br.read
    for i in range(nb_seq):
        of_code = int(of_syms[of_state])
        if of_code > OF_CODE_MAX:
            raise DecompressError("offset code out of range")
        # value bits read order: OF, ML, LL (RFC 8878 §3.1.1.3.2.1.2)
        of_val = (1 << of_code) + read(of_code) if of_code else 1
        ml_c = int(ml_syms[ml_state])
        ml_val = ML_BASELINES[ml_c] + (read(ML_BITS[ml_c]) if ML_BITS[ml_c] else 0)
        ll_c = int(ll_syms[ll_state])
        ll_val = LL_BASELINES[ll_c] + (read(LL_BITS[ll_c]) if LL_BITS[ll_c] else 0)
        lls[i] = ll_val
        mls[i] = ml_val
        ofs[i] = of_val
        if i + 1 < nb_seq:
            # state update read order: LL, ML, OF
            ll_state = int(ll_ns[ll_state]) + read(int(ll_nb[ll_state]))
            ml_state = int(ml_ns[ml_state]) + read(int(ml_nb[ml_state]))
            of_state = int(of_ns[of_state]) + read(int(of_nb[of_state]))
    if br.overflowed:
        raise DecompressError("sequence bitstream over-read")
    if not br.finished:
        raise DecompressError("sequence bitstream not fully consumed")
    return lls, mls, ofs, nb_seq


def execute_sequences(literals: bytes, lls: np.ndarray, mls: np.ndarray,
                      ofs: np.ndarray, rep: list[int], window: bytearray,
                      block_expected: int | None = None) -> bytes:
    """Run the LZ copy loop: repeat-offset resolution + literal/match copies.
    ``window`` is the decoded history (mutated: output appended); returns
    the bytes produced by this block."""
    out = window
    base = len(out)
    lit_pos = 0
    n = len(lls)
    for i in range(n):
        ll = int(lls[i])
        if ll:
            out += literals[lit_pos : lit_pos + ll]
            lit_pos += ll
        ov = int(ofs[i])
        if ov > 3:
            offset = ov - 3
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
        else:
            if ll != 0:
                if ov == 1:
                    offset = rep[0]
                elif ov == 2:
                    offset = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
                else:
                    offset = rep[2]
                    rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
            else:
                if ov == 1:
                    offset = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
                elif ov == 2:
                    offset = rep[2]
                    rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
                else:
                    offset = rep[0] - 1
                    if offset == 0:
                        raise DecompressError("repeat offset underflow")
                    rep[2] = rep[1]
                    rep[1] = rep[0]
                    rep[0] = offset
        ml = int(mls[i])
        start = len(out) - offset
        if start < 0:
            raise DecompressError("match offset beyond decoded history")
        if offset >= ml:
            out += out[start : start + ml]
        else:
            pattern = bytes(out[start:])
            reps = ml // offset + 1
            out += (pattern * reps)[:ml]
    out += literals[lit_pos:]
    produced = len(out) - base
    if block_expected is not None and produced != block_expected:
        raise DecompressError("block regenerated size mismatch")
    return bytes(out[base:])


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def encode_sequences(lls, mls, of_values, ll_table: fse.EncodeTable,
                     of_table: fse.EncodeTable, ml_table: fse.EncodeTable) -> bytes:
    """Build the sequences bitstream (mirrors ZSTD_encodeSequences_body
    structure: init on the last sequence, walk backward interleaving
    of/ml/ll state writes with value bits, flush ml/of/ll)."""
    n = len(lls)
    if n == 0:
        return b""
    w = BackwardBitWriter()
    ll_codes = [ll_code(int(v)) for v in lls]
    ml_codes = [ml_code(int(v)) for v in mls]
    of_codes = [int(v).bit_length() - 1 for v in of_values]

    last = n - 1
    ml_state = ml_table.init_state(ml_codes[last])
    of_state = of_table.init_state(of_codes[last])
    ll_state = ll_table.init_state(ll_codes[last])
    w.add(int(lls[last]) - LL_BASELINES[ll_codes[last]], LL_BITS[ll_codes[last]])
    w.add(int(mls[last]) - ML_BASELINES[ml_codes[last]], ML_BITS[ml_codes[last]])
    w.add(int(of_values[last]) - (1 << of_codes[last]), of_codes[last])
    for i in range(n - 2, -1, -1):
        of_state = of_table.encode(w, of_state, of_codes[i])
        ml_state = ml_table.encode(w, ml_state, ml_codes[i])
        ll_state = ll_table.encode(w, ll_state, ll_codes[i])
        w.add(int(lls[i]) - LL_BASELINES[ll_codes[i]], LL_BITS[ll_codes[i]])
        w.add(int(mls[i]) - ML_BASELINES[ml_codes[i]], ML_BITS[ml_codes[i]])
        w.add(int(of_values[i]) - (1 << of_codes[i]), of_codes[i])
    ml_table.flush(w, ml_state)
    of_table.flush(w, of_state)
    ll_table.flush(w, ll_state)
    return w.finish()


def write_nb_sequences(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([128 + (n >> 8), n & 0xFF])
    v = n - 0x7F00
    if v > 0xFFFF:
        raise CompressError("too many sequences for one block")
    return bytes([255, v & 0xFF, (v >> 8) & 0xFF])
