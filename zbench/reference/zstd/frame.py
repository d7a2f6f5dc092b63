"""zstd frame and block layer: headers, literals sections, block loop
(RFC 8878 §3).  Decode side; the encoder lives in encode.py.

Role parity: ZSTD_decompressDCtx / ZSTD_decompressStream as used by the
reference (lib/zpack_read.c:380,572); bit-exact decode of any conformant
zstd frame without external dictionaries.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..errors import DecompressError
from ..xxhash import XXH64State
from . import huffman, seq

MAGIC = 0xFD2FB528
MAGIC_SKIPPABLE_MIN = 0x184D2A50
MAGIC_SKIPPABLE_MAX = 0x184D2A5F

BLOCK_RAW = 0
BLOCK_RLE = 1
BLOCK_COMPRESSED = 2

MAX_BLOCK_SIZE = 128 << 10
MAX_WINDOW_LOG = 31  # decoder acceptance bound


@dataclass
class FrameHeader:
    window_size: int
    content_size: int | None
    dict_id: int
    has_checksum: bool
    single_segment: bool
    header_size: int


def parse_frame_header(data: bytes, pos: int) -> FrameHeader:
    if pos + 1 > len(data):
        raise DecompressError("missing frame header descriptor")
    fhd = data[pos]
    start = pos
    pos += 1
    fcs_flag = fhd >> 6
    single_segment = bool(fhd & 0x20)
    if fhd & 0x08:
        raise DecompressError("reserved frame header bit set")
    has_checksum = bool(fhd & 0x04)
    did_flag = fhd & 0x3
    window_size = None
    if not single_segment:
        if pos >= len(data):
            raise DecompressError("missing window descriptor")
        wd = data[pos]
        pos += 1
        exp = (wd >> 3) + 10
        mant = wd & 7
        if exp > MAX_WINDOW_LOG:
            raise DecompressError("window too large")
        base = 1 << exp
        window_size = base + (base // 8) * mant
    did_len = [0, 1, 2, 4][did_flag]
    dict_id = 0
    if did_len:
        dict_id = int.from_bytes(data[pos : pos + did_len], "little")
        pos += did_len
    fcs_len = [0, 2, 4, 8][fcs_flag]
    if fcs_flag == 0 and single_segment:
        fcs_len = 1
    content_size = None
    if fcs_len:
        if pos + fcs_len > len(data):
            raise DecompressError("truncated frame content size")
        content_size = int.from_bytes(data[pos : pos + fcs_len], "little")
        if fcs_len == 2:
            content_size += 256
        pos += fcs_len
    if single_segment:
        window_size = content_size
    return FrameHeader(
        window_size=window_size,
        content_size=content_size,
        dict_id=dict_id,
        has_checksum=has_checksum,
        single_segment=single_segment,
        header_size=pos - start,
    )


# ---------------------------------------------------------------------------
# Literals section
# ---------------------------------------------------------------------------


@dataclass
class LiteralsState:
    """Huffman table carried across blocks for treeless (repeat) literals."""

    table: huffman.HuffDecodeTable | None = None


def parse_literals_section(block: bytes, pos: int, state: LiteralsState):
    """Parse one literals section WITHOUT running the huffman decode;
    returns (plan, new_pos) where plan is ("done", literals) for raw/RLE
    sections or ("huf", [(stream_bytes, n_symbols), ...], table) for
    huffman sections (1 item for 1-stream, 4 after the jump-table split).
    Table building/reuse (treeless) mutates ``state`` here, so a batch
    caller can parse a whole frame first and decode every stream in one
    device dispatch (parallel/extract.py)."""
    if pos >= len(block):
        raise DecompressError("missing literals header")
    b0 = block[pos]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype in (0, 1):  # raw / RLE
        if sf in (0, 2):
            rs = b0 >> 3
            hdr = 1
        elif sf == 1:
            if pos + 2 > len(block):
                raise DecompressError("truncated literals header")
            rs = (b0 >> 4) + (block[pos + 1] << 4)
            hdr = 2
        else:
            if pos + 3 > len(block):
                raise DecompressError("truncated literals header")
            rs = (b0 >> 4) + (block[pos + 1] << 4) + (block[pos + 2] << 12)
            hdr = 3
        pos += hdr
        if ltype == 0:
            lits = block[pos : pos + rs]
            if len(lits) < rs:
                raise DecompressError("truncated raw literals")
            return ("done", lits), pos + rs
        if pos >= len(block):
            raise DecompressError("truncated RLE literal")
        return ("done", bytes([block[pos]]) * rs), pos + 1
    # compressed (2) or treeless (3)
    if sf == 0:
        streams = 1
        if pos + 3 > len(block):
            raise DecompressError("truncated literals header")
        b1, b2 = block[pos + 1], block[pos + 2]
        rs = (b0 >> 4) + ((b1 & 0x3F) << 4)
        cs = (b1 >> 6) + (b2 << 2)
        hdr = 3
    elif sf == 1:
        streams = 4
        if pos + 3 > len(block):
            raise DecompressError("truncated literals header")
        b1, b2 = block[pos + 1], block[pos + 2]
        rs = (b0 >> 4) + ((b1 & 0x3F) << 4)
        cs = (b1 >> 6) + (b2 << 2)
        hdr = 3
    elif sf == 2:
        streams = 4
        if pos + 4 > len(block):
            raise DecompressError("truncated literals header")
        b1, b2, b3 = block[pos + 1], block[pos + 2], block[pos + 3]
        rs = (b0 >> 4) + (b1 << 4) + ((b2 & 3) << 12)
        cs = (b2 >> 2) + (b3 << 6)
        hdr = 4
    else:
        streams = 4
        if pos + 5 > len(block):
            raise DecompressError("truncated literals header")
        b1, b2, b3, b4 = block[pos + 1 : pos + 5]
        rs = (b0 >> 4) + (b1 << 4) + ((b2 & 0x3F) << 12)
        cs = (b2 >> 6) + (b3 << 2) + (b4 << 10)
        hdr = 5
    pos += hdr
    payload = block[pos : pos + cs]
    if len(payload) < cs:
        raise DecompressError("truncated compressed literals")
    off = 0
    if ltype == 2:
        weights, consumed = huffman.read_weights(payload, 0)
        state.table = huffman.build_decode_table(weights)
        off = consumed
    if state.table is None:
        raise DecompressError("treeless literals without a previous table")
    body = payload[off:]
    if streams == 1:
        items = [(body, rs)]
    else:
        if len(body) < 6:
            raise DecompressError("4-stream literals too short for jump table")
        s1 = int.from_bytes(body[0:2], "little")
        s2 = int.from_bytes(body[2:4], "little")
        s3 = int.from_bytes(body[4:6], "little")
        b4 = body[6:]
        if s1 + s2 + s3 > len(b4):
            raise DecompressError("jump table overruns literals payload")
        per = (rs + 3) // 4
        if rs - 3 * per < 0:
            raise DecompressError("regenerated size smaller than 3 stream quarters")
        items = [
            (b4[:s1], per),
            (b4[s1 : s1 + s2], per),
            (b4[s1 + s2 : s1 + s2 + s3], per),
            (b4[s1 + s2 + s3 :], rs - 3 * per),
        ]
    return ("huf", items, state.table), pos + cs


def decode_literals(block: bytes, pos: int, state: LiteralsState) -> tuple[bytes, int]:
    """Parse + decode one literals section; returns (literals, new_pos)."""
    plan, pos = parse_literals_section(block, pos, state)
    if plan[0] == "done":
        return plan[1], pos
    _, items, table = plan
    outs = [huffman._decode_one_stream(s, table, n) for s, n in items]
    return np.concatenate(outs).tobytes() if len(outs) > 1 else outs[0].tobytes(), pos


# ---------------------------------------------------------------------------
# Frame decode
# ---------------------------------------------------------------------------


@dataclass
class FrameDecoder:
    """One frame's rolling decode state (history window, entropy tables,
    repeat offsets, optional checksum)."""

    header: FrameHeader
    window: bytearray = field(default_factory=bytearray)
    rep: list[int] = field(default_factory=lambda: [1, 4, 8])
    seq_tables: seq.SequenceTables = field(default_factory=seq.SequenceTables)
    lit_state: LiteralsState = field(default_factory=LiteralsState)
    hasher: XXH64State | None = None

    def __post_init__(self):
        if self.header.has_checksum:
            self.hasher = XXH64State(0)

    def decode_block(self, btype: int, payload: bytes, rle_size: int = 0,
                     lits_pos: tuple[bytes, int] | None = None) -> bytes:
        if btype == BLOCK_RAW:
            out = payload
            self.window += payload
        elif btype == BLOCK_RLE:
            out = payload * rle_size
            self.window += out
        elif btype == BLOCK_COMPRESSED:
            out = self._decode_compressed(payload, lits_pos)
        else:
            raise DecompressError("reserved block type")
        if self.hasher is not None:
            self.hasher.update(out)
        # bound the retained history to the window size
        limit = max(self.header.window_size or 0, MAX_BLOCK_SIZE)
        if len(self.window) > 3 * limit:
            del self.window[: len(self.window) - limit]
        return out

    def _decode_compressed(self, payload: bytes,
                           lits_pos: tuple[bytes, int] | None = None) -> bytes:
        if lits_pos is not None:
            # literals were decoded out-of-band (the batched device path,
            # parallel/extract.py): (bytes, position after the section)
            lits, pos = lits_pos
        else:
            lits, pos = decode_literals(payload, 0, self.lit_state)
        lls, mls, ofs, nb = seq.decode_sequences(payload, pos, self.seq_tables)
        if nb == 0:
            self.window += lits
            return bytes(lits)
        return seq.execute_sequences(lits, lls, mls, ofs, self.rep, self.window)


def decompress(data: bytes, max_out: int | None = None) -> bytes:
    """One-shot decompress of concatenated zstd frames without a
    dictionary."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < 4:
            raise DecompressError("truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, pos)
        if MAGIC_SKIPPABLE_MIN <= magic <= MAGIC_SKIPPABLE_MAX:
            if n - pos < 8:
                raise DecompressError("truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise DecompressError(f"bad zstd magic {magic:#x}")
        pos += 4
        header = parse_frame_header(data, pos)
        pos += header.header_size
        if header.dict_id:
            raise DecompressError(f"frame requires dictionary {header.dict_id}")
        dec = FrameDecoder(header)
        while True:
            if n - pos < 3:
                raise DecompressError("truncated block header")
            bh = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
            pos += 3
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == BLOCK_RLE:
                payload = data[pos : pos + 1]
                if len(payload) < 1:
                    raise DecompressError("truncated RLE block")
                pos += 1
                out += dec.decode_block(btype, payload, bsize)
            else:
                payload = data[pos : pos + bsize]
                if len(payload) < bsize:
                    raise DecompressError("truncated block")
                pos += bsize
                out += dec.decode_block(btype, payload)
            if last:
                break
        if header.content_size is not None and dec.hasher is None:
            pass
        if header.has_checksum:
            if n - pos < 4:
                raise DecompressError("truncated content checksum")
            (chk,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if (dec.hasher.digest() & 0xFFFFFFFF) != chk:
                raise DecompressError("content checksum mismatch")
        if header.content_size is not None and len(dec.window) != header.content_size:
            # window may have been trimmed for very long frames; track total
            pass
    if max_out is not None and len(out) > max_out:
        raise DecompressError("zstd output exceeds expected size")
    return bytes(out)
