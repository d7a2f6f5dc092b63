"""LZ4 frames and blocks, read independently of the program
(the LZ4 frame and block format descriptions, lz4/doc).

:func:`walk` checks a frame's structure (magic, descriptor, header
checksum, block sizes, end mark) without decoding a block; :func:`decode_block`
is a frozen copy of the port's plain-Python block decoder."""

from __future__ import annotations

import struct
from typing import NamedTuple

from .errors import DecompressError
from .xxhash import xxh32

MAGIC = 0x184D2204
SKIPPABLE = range(0x184D2A50, 0x184D2A60)
BLOCK_MAX = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
MIN_MATCH = 4


class Block(NamedTuple):
    start: int        # payload offset in the entry's bytes
    size: int
    compressed: bool
    out_pos: int | None  # where its output starts in the entry's content
    linked: bool      # a linked frame: matches may reach into earlier blocks


class Frame(NamedTuple):
    blocks: list
    bmax: int         # the frame's block maximum
    content_checksum: int | None


def walk(data: bytes) -> tuple[list[Frame], list[str]]:
    """The frames of an entry, block by block, and what is wrong with their
    structure.  Every block but a frame's last holds the frame's block
    maximum of content (as every LZ4 frame encoder writes them), so each
    block's place in the content is known without decoding, in the first
    frame and after frames that state their content size (None elsewhere)."""
    frames: list[Frame] = []
    pos, n, out = 0, len(data), 0
    try:
        while pos < n:
            if n - pos < 4:
                raise DecompressError("truncated magic")
            (magic,) = struct.unpack_from("<I", data, pos)
            if magic in SKIPPABLE:
                (size,) = struct.unpack_from("<I", data, pos + 4)
                pos += 8 + size
                continue
            if magic != MAGIC:
                raise DecompressError(f"bad magic {magic:#x}")
            pos += 4
            flg, bd = data[pos], data[pos + 1]
            if flg >> 6 != 1:
                raise DecompressError("frame version")
            desc = 2 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0)
            if (bd >> 4) & 7 not in BLOCK_MAX:
                raise DecompressError("block size id")
            bmax = BLOCK_MAX[(bd >> 4) & 7]
            if data[pos + desc] != (xxh32(bytes(data[pos:pos + desc]), 0) >> 8) & 0xFF:
                raise DecompressError("header checksum")
            size_field = (struct.unpack_from("<Q", data, pos + 2)[0]
                          if flg & 0x08 else None)
            pos += desc + 1
            first = out
            blocks = []
            while True:
                (word,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if word == 0:
                    break
                size = word & 0x7FFFFFFF
                if size > bmax or pos + size > n:
                    raise DecompressError("block size")
                blocks.append(Block(pos, size, not word >> 31, out, not flg & 0x20))
                pos += size + (4 if flg & 0x10 else 0)
                out = None if out is None else out + bmax
            chk = None
            if flg & 0x04:
                (chk,) = struct.unpack_from("<I", data, pos)
                pos += 4
            frames.append(Frame(blocks, bmax, chk))
            out = None if first is None or size_field is None else first + size_field
    except (DecompressError, struct.error, IndexError) as e:
        return frames, [f"frame structure: {e}"]
    if pos != n:
        return frames, ["frame structure: bytes after the last frame"]
    return frames, []


def decode_block(data: bytes, prefix: bytes = b"") -> bytes:
    """Decode one LZ4 block; ``prefix`` is the history a linked block's
    matches may reach into."""
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
        out += src[pos:pos + lit_len]
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
            out += out[start:start + match_len]
        else:
            pattern = out[start:]
            out += (bytes(pattern) * (match_len // offset + 1))[:match_len]
    return bytes(out[base:])
