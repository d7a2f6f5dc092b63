"""zstd encoder: spec-valid frames with level-scaled search effort.

Role parity: ZSTD_compressCCtx / ZSTD_compressStream2 as used by the
reference (lib/zpack_write.c:179,498).  Output is *not* byte-identical to
libzstd (encoders are free under RFC 8878); the archive contract requires
frames the reference decodes bit-exactly and sizes ≤ the reference's.

Pipeline per 128 KiB block:
  matcher (shared parallel-first LZ77, codecs/match.py) → greedy/lazy parse
  with repeat-offset tracking → literals section (raw / RLE / Huffman 1- or
  4-stream with package-merge length-limited codes) → sequence section
  (predefined vs freshly-normalized FSE tables vs RLE modes, whichever is
  smallest) → raw-block fallback when entropy coding loses.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ...errors import CompressError
from ..xxh3 import XXH64State
from .. import match as M
from . import fse, huffman, seq
from .frame import MAGIC, MAX_BLOCK_SIZE


@dataclass
class LevelParams:
    depth: int  # hash-chain follow depth
    lazy: bool
    window_log: int

    @classmethod
    def for_level(cls, level: int) -> "LevelParams":
        if level <= 1:
            return cls(depth=2, lazy=False, window_log=17)
        if level <= 3:
            return cls(depth=4, lazy=False, window_log=19)
        if level <= 6:
            return cls(depth=8, lazy=True, window_log=20)
        if level <= 12:
            return cls(depth=16, lazy=True, window_log=21)
        if level <= 17:
            return cls(depth=32, lazy=True, window_log=22)
        return cls(depth=64, lazy=True, window_log=23)


class _RleEncodeTable:
    """0-bit state machine for RLE sequence-code mode (decoder side:
    fse.build_rle_table)."""

    al = 0

    def init_state(self, symbol: int) -> int:
        return 0

    def encode(self, writer, state: int, symbol: int) -> int:
        return 0

    def flush(self, writer, state: int) -> None:
        pass


def _frame_header(content_size: int, window_log: int, checksum: bool = False,
                  dict_id: int = 0, min_window: int = 0) -> bytes:
    # single-segment for small payloads (no window descriptor), else an
    # explicit window descriptor + content size.  ``min_window`` forces an
    # explicit window covering at least that many bytes of back-reference
    # distance (dictionary prefix + content for dict frames).
    chk = 0x04 if checksum else 0
    if dict_id == 0:
        did_flag, did = 0, b""
    elif dict_id < 256:
        did_flag, did = 1, struct.pack("<B", dict_id)
    elif dict_id < 65536:
        did_flag, did = 2, struct.pack("<H", dict_id)
    else:
        did_flag, did = 3, struct.pack("<I", dict_id)
    # single-segment is legal for dict frames even though matches reach
    # into the dictionary: dict content precedes the frame's window by
    # definition (RFC 8878 §5; libzstd emits exactly this shape), so the
    # explicit-window form is only needed for dict-less min_window
    if content_size <= (256 << 10) and (min_window <= content_size or did_flag):
        if content_size < 256:
            fhd = 0x20 | (0 << 6) | chk | did_flag
            return struct.pack("<IB", MAGIC, fhd) + did + struct.pack("<B", content_size)
        if content_size <= 0xFFFF + 256:
            fhd = 0x20 | (1 << 6) | chk | did_flag
            return struct.pack("<IB", MAGIC, fhd) + did + struct.pack("<H", content_size - 256)
        fhd = 0x20 | (2 << 6) | chk | did_flag
        return struct.pack("<IB", MAGIC, fhd) + did + struct.pack("<I", content_size)
    # window descriptor: smallest (exp, mant) with value >= min(size, 1<<wlog)
    target = min(max(content_size, min_window), 1 << window_log)
    for exp in range(10, 31):
        base = 1 << exp
        for mant in range(8):
            if base + (base // 8) * mant >= target:
                wd = ((exp - 10) << 3) | mant
                if content_size <= 0xFFFFFFFF:
                    fhd = (2 << 6) | chk | did_flag
                    return (struct.pack("<IBB", MAGIC, fhd, wd) + did
                            + struct.pack("<I", content_size))
                fhd = (3 << 6) | chk | did_flag
                return (struct.pack("<IBB", MAGIC, fhd, wd) + did
                        + struct.pack("<Q", content_size))
    raise CompressError("window descriptor construction failed")


# ---------------------------------------------------------------------------
# Literals section encoding
# ---------------------------------------------------------------------------


def _literals_plan(lits: bytes):
    """Stage 1 of literal-section encoding: everything before the huffman
    bitstream build.  Returns ``(section, None)`` when decided outright
    (empty/RLE/raw/no-table), else ``(None, (arr, table, tree, streams))``
    — the pending huffman work, so a batch caller can run the bitstream
    stage on-device across many blocks (kernels/huffman_jax.py)."""
    rs = len(lits)
    if rs == 0:
        return bytes([0 << 3 | 0]), None  # raw, size 0, 1-byte header
    arr = np.frombuffer(lits, dtype=np.uint8)
    if rs > 1 and (arr == arr[0]).all():
        return _lit_header_raw_rle(1, rs) + lits[:1], None
    if rs >= 64:
        hist = np.bincount(arr, minlength=256)
        table = huffman.build_encode_table(hist)
        if table is not None:
            try:
                tree = huffman.write_weights(table.weights)
            except CompressError:
                return _lit_header_raw_rle(0, rs) + lits, None  # wide flat alphabet
            streams = 4 if rs >= 1024 else 1
            return None, (arr, table, tree, streams)
    return _lit_header_raw_rle(0, rs) + lits, None


def _literals_finish(lits: bytes, tree: bytes, streams: int, body: bytes | None) -> bytes:
    """Stage 2: wrap a built huffman body (host or device) into the literal
    section, falling back to raw when compression doesn't win."""
    rs = len(lits)
    if body is not None:
        cs = len(tree) + len(body)
        if cs + 5 < rs:  # only if it actually wins
            hdr = _lit_header_compressed(2, streams, rs, cs)
            if hdr is not None:
                return hdr + tree + body
    return _lit_header_raw_rle(0, rs) + lits


class EntropyState:
    """Per-frame entropy-table state for treeless literals + FSE repeat
    mode (libzstd's table reuse; decoder mirror: frame.LiteralsState +
    seq.SequenceTables).  Seed it from a dictionary's tables so small
    frames skip table headers entirely (RFC 8878 §5 repeat-mode)."""

    __slots__ = ("huf", "ll", "of", "ml")

    def __init__(self, huf=None, ll=None, of=None, ml=None):
        self.huf = huf
        self.ll = ll
        self.of = of
        self.ml = ml

    def copy(self) -> "EntropyState":
        return EntropyState(self.huf, self.ll, self.of, self.ml)


def _encode_literals(lits: bytes, ent: "EntropyState | None" = None) -> bytes:
    section, pending = _literals_plan(lits)
    if pending is None:
        return section
    arr, table, tree, streams = pending
    if streams == 4:
        body = huffman.encode_4stream(lits, table)
    else:
        body = huffman.encode_1stream(lits, table)
    own = _literals_finish(lits, tree, streams, body)
    if ent is not None and ent.huf is not None:
        # treeless candidate: reuse the current table, pay no tree bytes
        try:
            tl_body = (huffman.encode_4stream(lits, ent.huf) if streams == 4
                       else huffman.encode_1stream(lits, ent.huf))
        except (CompressError, IndexError):
            tl_body = None  # a symbol has no code in the reused table
        if tl_body is not None and len(tl_body) < len(lits):
            hdr = _lit_header_compressed(3, streams, len(lits), len(tl_body))
            if hdr is not None and len(hdr) + len(tl_body) < len(own):
                return hdr + tl_body
    if ent is not None and own[0] & 3 == 2:
        ent.huf = table  # decoder replaces its table on a compressed section
    return own


def encode_literal_sections(lits_list: list[bytes], device_encoder=None) -> list[bytes]:
    """Encode many blocks' literal sections at once.

    With ``device_encoder`` (kernels.huffman_jax.DeviceHuffmanEncoder) every
    block's huffman bitstreams are built in ONE batched device dispatch —
    the entropy stage of the mesh zstd pipeline runs on the TPU instead of
    the host (BASELINE north star; role of the reference's vendored HUF_*
    behind lib/zpack_write.c:179)."""
    sections: list[bytes | None] = [None] * len(lits_list)
    pend = []  # (i, lits, arr, table, tree, streams)
    for i, lits in enumerate(lits_list):
        sec, pending = _literals_plan(lits)
        if pending is None:
            sections[i] = sec
            continue
        arr, table, tree, streams = pending
        pend.append((i, lits, arr, table, tree, streams))
    if pend:
        if device_encoder is None:
            for i, lits, arr, table, tree, streams in pend:
                body = (huffman.encode_4stream(lits, table) if streams == 4
                        else huffman.encode_1stream(lits, table))
                sections[i] = _literals_finish(lits, tree, streams, body)
        else:
            four = [(i, lits, arr, table, tree) for i, lits, arr, table, tree, s in pend if s == 4]
            one = [(i, lits, arr, table, tree) for i, lits, arr, table, tree, s in pend if s == 1]
            if four:
                bodies = device_encoder.encode_4stream_batch(
                    [p[2] for p in four], [p[3] for p in four])
                for (i, lits, _a, _t, tree), body in zip(four, bodies):
                    sections[i] = _literals_finish(lits, tree, 4, body)
            if one:
                bodies = device_encoder.encode_batch(
                    [p[2] for p in one], [p[3] for p in one])
                for (i, lits, _a, _t, tree), body in zip(one, bodies):
                    sections[i] = _literals_finish(lits, tree, 1, body)
    return sections


def _lit_header_raw_rle(ltype: int, rs: int) -> bytes:
    if rs < 32:
        return bytes([ltype | (0 << 2) | (rs << 3)])
    if rs < 4096:
        b0 = ltype | (1 << 2) | ((rs & 0xF) << 4)
        return bytes([b0, rs >> 4])
    b0 = ltype | (3 << 2) | ((rs & 0xF) << 4)
    return bytes([b0, (rs >> 4) & 0xFF, rs >> 12])


def _lit_header_compressed(ltype: int, streams: int, rs: int, cs: int) -> bytes | None:
    if streams == 1:
        if rs > 1023 or cs > 1023:
            return None
        b0 = ltype | (0 << 2) | ((rs & 0xF) << 4)
        b1 = (rs >> 4) | ((cs & 3) << 6)
        b2 = cs >> 2
        return bytes([b0, b1, b2])
    if rs <= 1023 and cs <= 1023:
        b0 = ltype | (1 << 2) | ((rs & 0xF) << 4)
        b1 = (rs >> 4) | ((cs & 3) << 6)
        b2 = cs >> 2
        return bytes([b0, b1, b2])
    if rs <= 16383 and cs <= 16383:
        b0 = ltype | (2 << 2) | ((rs & 0xF) << 4)
        b1 = (rs >> 4) & 0xFF
        b2 = (rs >> 12) | ((cs & 0x3F) << 2)
        b3 = cs >> 6
        return bytes([b0, b1, b2, b3])
    if rs <= 262143 and cs <= 262143:
        b0 = ltype | (3 << 2) | ((rs & 0xF) << 4)
        b1 = (rs >> 4) & 0xFF
        b2 = ((rs >> 12) & 0x3F) | ((cs & 3) << 6)
        b3 = (cs >> 2) & 0xFF
        b4 = cs >> 10
        return bytes([b0, b1, b2, b3, b4])
    return None


# ---------------------------------------------------------------------------
# Sequence section encoding
# ---------------------------------------------------------------------------


def _pick_table(codes: list[int], kind: str, max_code: int, max_al: int,
                prev=None):
    """Choose predefined / RLE / custom-FSE / repeat for one code stream;
    returns (mode, table, description_bytes).  ``prev`` (an EncodeTable
    with counts — the previous block's or the dictionary's) enables
    repeat mode (3): reuse it with zero description bytes when its
    distribution prices this stream below a fresh/predefined table."""
    hist = np.bincount(np.array(codes, dtype=np.int64), minlength=max_code + 1)
    nz = np.flatnonzero(hist)
    if len(nz) == 1:
        return 1, _RleEncodeTable(), bytes([int(nz[0])])
    pre = seq.predefined_encode_table(kind)
    # estimated cost with predefined vs custom
    total = len(codes)
    al = fse.optimal_accuracy_log(total, int(nz[-1]), max_al)
    try:
        counts = fse.normalize_counts(hist, al, total)
        desc = fse.write_ncount(counts, al)
        custom = fse.build_encode_table(counts, al)
    except CompressError:
        return 0, pre, b""
    # entropy cost comparison (approximate: bits per symbol from counts)
    def cost(table_counts, table_al, overhead):
        size = 1 << table_al
        bits = 0.0
        for c, cnt in zip(range(len(hist)), hist):
            if cnt == 0:
                continue
            p = table_counts[c] if c < len(table_counts) else 0
            p = 1 if p == -1 else p
            if p == 0:
                return float("inf")
            bits += cnt * (table_al - np.log2(p))
        return bits / 8 + overhead

    dist = {"ll": seq.LL_DEFAULT_DIST, "ml": seq.ML_DEFAULT_DIST, "of": seq.OF_DEFAULT_DIST}[kind]
    c_pre = cost(dist, {"ll": 6, "ml": 6, "of": 5}[kind], 0)
    c_cus = cost(counts, al, len(desc))
    c_rep = float("inf")
    if prev is not None and getattr(prev, "counts", None) is not None:
        c_rep = cost(prev.counts, prev.al, 0)
    if c_rep <= c_cus and c_rep <= c_pre:
        return 3, prev, b""
    if c_cus < c_pre:
        return 2, custom, desc
    return 0, pre, b""


def _block_literals(data_arr: np.ndarray, sequences: list) -> bytes:
    """The literal bytes a block body will carry, in emission order —
    lets a batch caller pre-encode literal sections on-device."""
    return b"".join(
        data_arr[ls : ls + ln].tobytes() for ls, ln, _p, _j, _ml in sequences if ln
    )


def sequence_fields(data_arr: np.ndarray, sequences: list, rep: list[int]):
    """Resolve the parse's sequence tuples into the wire fields
    (lls, mls, ovs) lists + the block's literal byte count, ADVANCING
    ``rep`` exactly like the block body encoder (the caller owns
    backup/rollback when the block ends up raw)."""
    lls, mls, ovs = [], [], []
    n_lits = 0
    pending_lit = 0  # literal-only runs fold into the next sequence's ll
    for lit_start, lit_len, p, j, ml in sequences:
        n_lits += lit_len
        if p is None:
            pending_lit += lit_len
            continue
        offset = p - j
        ll = lit_len + pending_lit
        pending_lit = 0
        ov = _offset_value(offset, ll, rep)
        lls.append(ll)
        mls.append(ml)
        ovs.append(ov)
    return lls, mls, ovs, n_lits


def sequence_section_header(lls, mls, ovs, ent: "EntropyState | None" = None):
    """Pick the three FSE table modes for a non-empty sequence list;
    returns (header_bytes = nb_sequences + modes byte + table descriptions,
    (ll_t, of_t, ml_t) encode tables, upper-bound bitstream bits).  The
    upper bound (every state write at full accuracy-log width) lets a
    batch caller decide compressed-vs-raw BEFORE the bitstream is packed
    on device (parallel/pipeline.py).  ``ent`` enables FSE repeat mode
    against the previous block's / the dictionary's tables and is updated
    with whatever tables this section uses (decoder mirror:
    seq._read_table's ``prev`` threading)."""
    ll_codes = [seq.ll_code(v) for v in lls]
    ml_codes = [seq.ml_code(v) for v in mls]
    of_codes = [v.bit_length() - 1 for v in ovs]
    ll_mode, ll_t, ll_d = _pick_table(ll_codes, "ll", seq.LL_CODE_MAX,
                                      seq.LL_MAX_AL, ent.ll if ent else None)
    of_mode, of_t, of_d = _pick_table(of_codes, "of", seq.OF_CODE_MAX,
                                      seq.OF_MAX_AL, ent.of if ent else None)
    ml_mode, ml_t, ml_d = _pick_table(ml_codes, "ml", seq.ML_CODE_MAX,
                                      seq.ML_MAX_AL, ent.ml if ent else None)
    if ent is not None:
        ent.ll, ent.of, ent.ml = ll_t, of_t, ml_t
    header = bytearray(seq.write_nb_sequences(len(lls)))
    header.append((ll_mode << 6) | (of_mode << 4) | (ml_mode << 2))
    header += ll_d + of_d + ml_d
    als = ll_t.al + of_t.al + ml_t.al
    extras = sum(seq.LL_BITS[c] for c in ll_codes)
    extras += sum(seq.ML_BITS[c] for c in ml_codes)
    extras += sum(of_codes)
    ub_bits = len(lls) * als + extras + als + 1  # states + extras + flush + sentinel
    return bytes(header), (ll_t, of_t, ml_t), ub_bits


def _encode_block_body(data_arr: np.ndarray, block_start: int, block_end: int,
                       sequences: list, rep: list[int],
                       lit_section: bytes | None = None,
                       ent: "EntropyState | None" = None) -> bytes | None:
    """Build one compressed-block body (literals + sequences sections);
    returns None if the caller should emit a raw block instead.

    ``lit_section`` short-circuits literal encoding with a pre-built
    section (the device-entropy path, parallel/pipeline.py).  ``ent``
    carries entropy-table state across blocks/from a dictionary for
    treeless literals + FSE repeat mode (caller restores it when the
    block is emitted raw)."""
    lls, mls, ovs, _n_lits = sequence_fields(data_arr, sequences, rep)
    if lit_section is None:
        lits = _block_literals(data_arr, sequences)
        out = bytearray(_encode_literals(lits, ent))
    else:
        out = bytearray(lit_section)
    nb = len(lls)
    if nb:
        header, (ll_t, of_t, ml_t), _ub = sequence_section_header(lls, mls, ovs, ent)
        out += header
        out += seq.encode_sequences(lls, mls, ovs, ll_t, of_t, ml_t)
    else:
        out += seq.write_nb_sequences(0)
    return bytes(out)


def _rep_match_len(arr: np.ndarray, p: int, offset: int, end_limit: int) -> int:
    """Length of the match at p against offset (growing-chunk compare)."""
    if offset <= 0 or p < offset:
        return 0
    limit = end_limit - p
    total = 0
    chunk = 64
    while total < limit:
        take = min(chunk, limit - total)
        a = arr[p + total : p + total + take]
        b = arr[p - offset + total : p - offset + total + take]
        neq = np.flatnonzero(a != b)
        if len(neq):
            return total + int(neq[0])
        total += take
        chunk = min(chunk * 4, 1 << 16)
    return total


def _parse_with_reps(arr: np.ndarray, src: np.ndarray, mlen: np.ndarray,
                     end_limit: int, lazy: bool, start: int = 0,
                     rep_init: list[int] | None = None):
    """Greedy parse that, like libzstd's greedy/lazy search, explicitly
    probes repeat-offset matches (cheap to encode: ~2 bits vs 10+ for a
    fresh offset) at the current and next position before accepting a
    hash-chain match.  Yields the same tuples as match.greedy_parse.

    ``start`` > 0 parses only [start, n) while matches may still reference
    earlier bytes — the dictionary-prefix mode."""
    n = len(arr)
    usable = np.flatnonzero(mlen >= M.MIN_MATCH)
    usable = usable[usable > 0]
    nu = len(usable)
    rep = list(rep_init) if rep_init is not None else [1, 4, 8]

    def rep_probe(p, ll_nonzero):
        """Best repeat-offset match at p: (length, offset)."""
        cands = (rep[0], rep[1], rep[2]) if ll_nonzero else (rep[1], rep[2], rep[0] - 1)
        best = (0, 0)
        for off in cands:
            if off <= 0:
                continue
            l = _rep_match_len(arr, p, off, end_limit)
            if l > best[0]:
                best = (l, off)
        return best

    def advance_rep(offset, ll):
        # mirror of _offset_value's update rules without the wire value
        if ll != 0:
            if offset == rep[0]:
                return
            if offset == rep[1]:
                rep[1] = rep[0]; rep[0] = offset; return
            if offset == rep[2]:
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset; return
        else:
            if offset == rep[1]:
                rep[1] = rep[0]; rep[0] = offset; return
            if offset == rep[2]:
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset; return
            if offset == rep[0] - 1:
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset; return
        rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset

    pos = start
    lit_start = start
    while pos < n:
        # probe rep matches at pos and pos+1 (covers match-continuation
        # after 0 or 1 literal, the dominant patterns)
        rl0, ro0 = rep_probe(pos, pos != lit_start)
        if rl0 < M.MIN_MATCH and pos + 1 < n:
            rl1, ro1 = rep_probe(pos + 1, True)
        else:
            rl1, ro1 = 0, 0
        k = int(np.searchsorted(usable, pos))
        p_hash = int(usable[k]) if k < nu else None
        # choose the best action
        if rl0 >= M.MIN_MATCH and (p_hash is None or p_hash > pos or rl0 + 1 >= int(mlen[pos])):
            p, off, ml = pos, ro0, rl0
        elif rl1 >= M.MIN_MATCH and (p_hash is None or p_hash > pos + 1 or rl1 + 1 >= int(mlen[pos + 1])):
            p, off, ml = pos + 1, ro1, rl1
        elif p_hash is not None:
            p = p_hash
            j = int(src[p])
            ml = int(mlen[p])
            if lazy and p + 1 < len(mlen) and int(mlen[p + 1]) > ml + 2:
                pos = p + 1
                continue
            if ml >= M.CAP:
                ml = M.exact_extend(arr, p, j, ml, end_limit)
            ml = min(ml, end_limit - p)
            if ml < M.MIN_MATCH:
                pos = p + 1
                continue
            off = p - j
        else:
            break
        yield (lit_start, p - lit_start, p, p - off, ml)
        advance_rep(off, p - lit_start)
        pos = p + ml
        lit_start = pos
    yield (lit_start, n - lit_start, None, None, None)


def _offset_value(offset: int, lit_len: int, rep: list[int]) -> int:
    """Map an absolute offset to the wire offset-value, preferring repeat
    codes; mirrors the decoder's repeat-offset update rules exactly
    (RFC 8878 §3.1.1.5)."""
    if lit_len != 0:
        if offset == rep[0]:
            return 1
        if offset == rep[1]:
            rep[1] = rep[0]
            rep[0] = offset
            return 2
        if offset == rep[2]:
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
            return 3
    else:
        if offset == rep[1]:
            rep[1] = rep[0]
            rep[0] = offset
            return 1
        if offset == rep[2]:
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
            return 2
        if offset == rep[0] - 1:
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
            return 3
    rep[2] = rep[1]
    rep[1] = rep[0]
    rep[0] = offset
    return offset + 3


def compress(data: bytes, level: int = 3, *, checksum: bool = False,
             dictionary=None) -> bytes:
    """One-shot frame compression.

    ``dictionary`` (ZstdDict or blob) switches on dictionary-prefix mode
    (no reference counterpart — ZPack never passes dictionaries to zstd):
    the dict content becomes match-window history before position 0, the
    initial repeat offsets come from the dict, and the frame header carries
    the dict_id so decoders demand the same dictionary."""
    data = bytes(data)
    params = LevelParams.for_level(level)
    n = len(data)
    zd = None
    d = 0
    if dictionary is not None:
        from .dict import as_dictionary

        zd = as_dictionary(dictionary)
        d = len(zd.content)
    window_log = params.window_log
    if d:
        window_log = min(27, max(window_log, (d + n).bit_length()))
    out = bytearray(_frame_header(n, window_log, checksum,
                                  dict_id=zd.dict_id if zd else 0,
                                  min_window=d + n if d else 0))
    if n == 0:
        out += struct.pack("<I", 1)[:3]  # last=1, raw, size 0
        if checksum:
            out += struct.pack("<I", XXH64State(0).digest() & 0xFFFFFFFF)
        return bytes(out)

    full = zd.content + data if d else data
    arr = np.frombuffer(full, dtype=np.uint8)
    max_offset = min((1 << window_log) - 1, len(full))
    src, mlen = M.find_matches(arr, params.depth, max_offset)

    # global parse, then split sequences at block boundaries
    rep = list(zd.rep) if zd else [1, 4, 8]
    blocks: list[bytes] = []
    nblocks = (n + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
    parse = _parse_with_reps(arr, src, mlen, end_limit=len(full),
                             lazy=params.lazy, start=d, rep_init=rep)
    seqs_per_block: list[list] = [[] for _ in range(nblocks)]
    for lit_start, lit_len, p, j, ml in parse:
        _split_into_blocks(seqs_per_block, lit_start, lit_len, p, j, ml, base=d)

    # entropy-table state: seeded from the dictionary's tables when it has
    # them (treeless literals + FSE repeat mode on the first block — the
    # libzstd dict repeat-mode header saving), then threaded block to block
    ent = None
    if zd is not None:
        enc_tabs = zd.encode_tables()
        if enc_tabs is not None:
            ent = EntropyState(*enc_tabs)
    hasher = XXH64State(0) if checksum else None
    for bi in range(nblocks):
        b_start = d + bi * MAX_BLOCK_SIZE
        b_end = min(d + n, b_start + MAX_BLOCK_SIZE)
        raw = data[b_start - d : b_end - d]
        if hasher is not None:
            hasher.update(raw)
        rep_backup = list(rep)
        ent_backup = ent.copy() if ent is not None else None
        body = _encode_block_body(arr, b_start, b_end, seqs_per_block[bi], rep,
                                  ent=ent)
        last = 1 if bi == nblocks - 1 else 0
        if body is not None and len(body) < len(raw):
            bh = last | (2 << 1) | (len(body) << 3)
            out += struct.pack("<I", bh)[:3]
            out += body
        else:
            rep[:] = rep_backup  # raw blocks don't advance repeat offsets
            if ent is not None:  # nor the decoder's entropy tables
                ent.huf, ent.ll, ent.of, ent.ml = (
                    ent_backup.huf, ent_backup.ll, ent_backup.of, ent_backup.ml)
            if len(set(raw)) == 1 and len(raw) > 4:
                bh = last | (1 << 1) | (len(raw) << 3)
                out += struct.pack("<I", bh)[:3]
                out += raw[:1]
            else:
                bh = last | (0 << 1) | (len(raw) << 3)
                out += struct.pack("<I", bh)[:3]
                out += raw
    if hasher is not None:
        out += struct.pack("<I", hasher.digest() & 0xFFFFFFFF)
    return bytes(out)


class StreamCompressor:
    """Chunked compression (role parity: ZSTD_compressStream2 with
    e_continue / e_end, lib/zpack_write.c:498,602-614).

    Emits one frame per ~8 MiB of input; concatenated frames are valid
    zstd and stream-decodable (ZSTD_decompressStream re-inits per frame),
    and chunk independence is what lets the TPU path compress chunks
    data-parallel across the mesh."""

    CHUNK = 8 << 20

    def __init__(self, level: int = 3, dictionary=None):
        self.level = level
        self._buf = bytearray()
        self._dict = None
        if dictionary is not None:
            from .dict import as_dictionary

            self._dict = as_dictionary(dictionary)

    def _compress_chunk(self, data: bytes) -> bytes:
        from ... import native

        if self._dict is not None:
            return compress(data, self.level, dictionary=self._dict)
        comp = native.zstd_compress(data, self.level)
        if comp is not None:
            return comp
        return compress(data, self.level)

    def update(self, chunk: bytes) -> bytes:
        self._buf += chunk
        out = bytearray()
        while len(self._buf) >= self.CHUNK:
            out += self._compress_chunk(bytes(self._buf[: self.CHUNK]))
            del self._buf[: self.CHUNK]
        return bytes(out)

    def finish(self) -> bytes:
        out = self._compress_chunk(bytes(self._buf)) if self._buf else b""
        self._buf.clear()
        return out


def _split_into_blocks(per_block: list[list], lit_start, lit_len, p, j, ml,
                       base: int = 0):
    """Assign one parsed sequence to block buckets, splitting literal runs
    and matches that straddle 128 KiB block boundaries.  ``base`` shifts
    the block grid (dictionary-prefix mode: blocks cover [base, n))."""
    B = MAX_BLOCK_SIZE
    if p is None:
        # trailing literals: split across blocks
        pos = lit_start
        end = lit_start + lit_len
        while pos < end:
            bi = (pos - base) // B
            take = min(end, base + (bi + 1) * B) - pos
            per_block[bi].append((pos, take, None, None, None))
            pos += take
        return
    # literal run first: whole-block spans become standalone literal runs;
    # the tail (same block as the match start) rides with the match sequence
    pos = lit_start
    lit_end = p
    while pos < lit_end:
        bi = (pos - base) // B
        boundary = base + (bi + 1) * B
        if lit_end < boundary:
            break
        take = boundary - pos
        per_block[bi].append((pos, take, None, None, None))
        pos += take
    # match (with its preceding literals), split at boundaries
    mpos, msrc, mleft = p, j, ml
    first = True
    while mleft > 0:
        bi = (mpos - base) // B
        boundary = base + (bi + 1) * B
        take = min(mleft, boundary - mpos)
        if take < 4:
            # too short to stand as a match in this block: demote to literals
            # (the demoted positions hold the same bytes by match definition)
            per_block[bi].append((pos if first else mpos, (mpos - pos if first else 0) + take,
                                  None, None, None))
            msrc += take
            mpos += take
            mleft -= take
            first = False
            continue
        per_block[bi].append((pos if first else mpos, mpos - pos if first else 0,
                              mpos, msrc, take))
        msrc += take
        mpos += take
        mleft -= take
        first = False
