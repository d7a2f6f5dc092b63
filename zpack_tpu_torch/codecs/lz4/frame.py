"""LZ4 *frame* format (lz4f) — what ZPack stores on disk for method 2
(reference: docs/specs.md:101 "The LZ4 frame format is used"; the reference
library calls LZ4F_compressBegin/Update/End and LZ4F_decompress,
lib/zpack_write.c:204-211,518-531,623 and lib/zpack_read.c:414-439,598).

Implements the public LZ4 Frame specification v1.6.x:
magic ‖ FLG ‖ BD ‖ [content size] ‖ [dict id] ‖ HC ‖ blocks… ‖ EndMark ‖
[content checksum], plus skippable frames.

The native one-shot encoder emits *linked* blocks (liblz4's default,
~4.5% smaller on mixed data; matches may reach 64 KiB into earlier
blocks) with per-thread contiguous block ranges so parallel encode keeps
a warm match table.  The pure-python and mesh/TPU encoders emit
*independent* blocks (device-parallel encode AND decode).  Both modes are
spec-valid and readable by any lz4f decoder, including the reference CLI.
The decoder handles both (the golden archive uses linked blocks);
independent-block frames additionally decode block-parallel.
"""

from __future__ import annotations

import struct

from ... import native
from ...errors import CompressError, DecompressError
from ..xxh3 import XXH32State, xxh32
from . import block as lz4block

MAGIC = 0x184D2204
MAGIC_SKIPPABLE_MIN = 0x184D2A50
MAGIC_SKIPPABLE_MAX = 0x184D2A5F

_BLOCK_SIZES = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
_BLOCK_SIZE_IDS = {v: k for k, v in _BLOCK_SIZES.items()}

DEFAULT_BLOCK_SIZE = 64 << 10


def _header(block_size: int, block_indep: bool, content_checksum: bool,
            content_size: int | None, block_checksum: bool = False) -> bytes:
    flg = 0x40  # version 01
    if block_indep:
        flg |= 0x20
    if block_checksum:
        flg |= 0x10
    if content_size is not None:
        flg |= 0x08
    if content_checksum:
        flg |= 0x04
    bd = _BLOCK_SIZE_IDS[block_size] << 4
    desc = bytes([flg, bd])
    if content_size is not None:
        desc += struct.pack("<Q", content_size)
    hc = (xxh32(desc, 0) >> 8) & 0xFF
    return struct.pack("<I", MAGIC) + desc + bytes([hc])


def compress_frame(data: bytes, level: int = 1, *,
                   block_size: int = DEFAULT_BLOCK_SIZE,
                   block_indep: bool | None = None,
                   content_checksum: bool = False,
                   store_content_size: bool = False) -> bytes:
    """One-shot frame compression (role parity: the LZ4F one-shot path in
    zpack_compress_file, lib/zpack_write.c:204-211).

    ``block_indep=None`` (default) picks the best available mode: the
    native backend emits LINKED blocks (liblz4's default, ~10% smaller on
    compressible data); the pure-python fallback emits independent blocks
    (spec-valid either way).  Pass True to force independent blocks."""
    data = bytes(data)
    if (level <= 2 and block_size == DEFAULT_BLOCK_SIZE
            and block_indep is not True
            and not content_checksum and not store_content_size):
        comp = native.lz4f_compress(data, level)  # linked blocks
        if comp is not None:
            return comp
    indep = True if block_indep is None else block_indep
    out = bytearray(
        _header(block_size, indep, content_checksum,
                len(data) if store_content_size else None)
    )
    for i in range(0, len(data), block_size):
        chunk = data[i : i + block_size]
        if indep or i == 0:
            comp = lz4block.compress_block(chunk, level)
        else:
            # linked mode would pass history; the python encoder emits
            # only independent blocks — force-independent header above
            comp = lz4block.compress_block(chunk, level)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
    out += struct.pack("<I", 0)  # EndMark
    if content_checksum:
        out += struct.pack("<I", xxh32(data, 0))
    return bytes(out)


class FrameDecompressor:
    """Incremental lz4f decoder (role parity: LZ4F_decompress as used by the
    streaming read path, lib/zpack_read.c:598).  Feed arbitrary chunks with
    :meth:`update`; all input is consumed (internal buffering), so the
    ZPack-level stream ``read_back`` is always 0 with this decoder."""

    def __init__(self):
        self._buf = bytearray()
        self._state = "magic"
        self._flg = 0
        self._block_max = 0
        self._content_size = None
        self._linked_history = bytearray()
        self._content_hash = None
        self._skippable_left = 0
        self.finished = False
        self.total_out = 0

    # header field helpers
    @property
    def _block_indep(self):
        return bool(self._flg & 0x20)

    @property
    def _block_checksum(self):
        return bool(self._flg & 0x10)

    @property
    def _has_content_size(self):
        return bool(self._flg & 0x08)

    @property
    def _has_content_checksum(self):
        return bool(self._flg & 0x04)

    def update(self, chunk: bytes) -> bytes:
        if self.finished and chunk:
            self.finished = False  # concatenated frame follows
            self._state = "magic"
        self._buf += chunk
        out = bytearray()
        progress = True
        while progress and not self.finished:
            progress = self._step(out)
        if out:
            self.total_out += len(out)
        return bytes(out)

    def _step(self, out: bytearray) -> bool:
        buf = self._buf
        if self._state == "magic":
            if len(buf) < 4:
                return False
            (magic,) = struct.unpack_from("<I", buf, 0)
            if MAGIC_SKIPPABLE_MIN <= magic <= MAGIC_SKIPPABLE_MAX:
                if len(buf) < 8:
                    return False
                (size,) = struct.unpack_from("<I", buf, 4)
                del buf[:8]
                self._skippable_left = size
                self._state = "skippable"
                return True
            if magic != MAGIC:
                raise DecompressError(f"bad lz4 frame magic {magic:#x}")
            del buf[:4]
            self._state = "descriptor"
            return True
        if self._state == "skippable":
            take = min(self._skippable_left, len(buf))
            del buf[:take]
            self._skippable_left -= take
            if self._skippable_left == 0:
                self._state = "magic"
                return True
            return False
        if self._state == "descriptor":
            if len(buf) < 2:
                return False
            flg, bd = buf[0], buf[1]
            if (flg >> 6) != 1:
                raise DecompressError("unsupported lz4 frame version")
            desc_len = 2 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0)
            if len(buf) < desc_len + 1:
                return False
            self._flg = flg
            bsid = (bd >> 4) & 0x7
            if bsid not in _BLOCK_SIZES:
                raise DecompressError(f"bad lz4 block size id {bsid}")
            self._block_max = _BLOCK_SIZES[bsid]
            if flg & 0x08:
                (self._content_size,) = struct.unpack_from("<Q", buf, 2)
            hc = buf[desc_len]
            expect = (xxh32(bytes(buf[:desc_len]), 0) >> 8) & 0xFF
            if hc != expect:
                raise DecompressError("lz4 frame header checksum mismatch")
            del buf[: desc_len + 1]
            if self._has_content_checksum:
                self._content_hash = XXH32State(0)
            self._state = "block"
            return True
        if self._state == "block":
            if len(buf) < 4:
                return False
            (bsize,) = struct.unpack_from("<I", buf, 0)
            if bsize == 0:  # EndMark
                del buf[:4]
                self._state = "checksum" if self._has_content_checksum else "done"
                return True
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            if bsize > self._block_max:
                raise DecompressError("lz4 block larger than declared maximum")
            need = 4 + bsize + (4 if self._block_checksum else 0)
            if len(buf) < need:
                return False
            payload = bytes(buf[4 : 4 + bsize])
            if self._block_checksum:
                (bchk,) = struct.unpack_from("<I", buf, 4 + bsize)
                if xxh32(payload, 0) != bchk:
                    raise DecompressError("lz4 block checksum mismatch")
            del buf[:need]
            if uncompressed:
                decoded = payload
            else:
                prefix = b"" if self._block_indep else bytes(self._linked_history)
                decoded = lz4block.decompress_block(payload, self._block_max, prefix)
            if not self._block_indep:
                self._linked_history += decoded
                if len(self._linked_history) > 65536:
                    del self._linked_history[: len(self._linked_history) - 65536]
            if self._content_hash is not None:
                self._content_hash.update(decoded)
            out += decoded
            return True
        if self._state == "checksum":
            if len(buf) < 4:
                return False
            (chk,) = struct.unpack_from("<I", buf, 0)
            del buf[:4]
            if self._content_hash.digest() != chk:
                raise DecompressError("lz4 content checksum mismatch")
            self._state = "done"
            return True
        if self._state == "done":
            if buf:
                # concatenated frames (LZ4F_decompress decodes successive
                # frames with one context; so do we)
                self._state = "magic"
                self._flg = 0
                self._linked_history.clear()
                self._content_hash = None
                self.finished = False
                return True
            self.finished = True
            return False
        raise DecompressError(f"bad decoder state {self._state}")

    def pending_input(self) -> int:
        return len(self._buf)


def decompress_frame(data: bytes, max_out: int | None = None) -> bytes:
    if max_out is not None:
        out = native.lz4f_decompress(bytes(data), max_out)
        if out is not None:
            return out
    d = FrameDecompressor()
    out = d.update(bytes(data))
    if not d.finished:
        raise DecompressError("truncated lz4 frame")
    if max_out is not None and len(out) > max_out:
        raise DecompressError("lz4 frame output exceeds expected size")
    return out


class FrameCompressor:
    """Incremental lz4f encoder (role parity: LZ4F_compressBegin/Update/End,
    lib/zpack_write.c:518-531,623).  Buffers to whole blocks; emits the frame
    header on the first output."""

    def __init__(self, level: int = 1, *, block_size: int = DEFAULT_BLOCK_SIZE,
                 content_checksum: bool = False):
        self.level = level
        self.block_size = block_size
        self.content_checksum = content_checksum
        self._buf = bytearray()
        self._started = False
        self._finished = False
        self._hash = XXH32State(0) if content_checksum else None

    def _start(self) -> bytes:
        self._started = True
        return _header(self.block_size, True, self.content_checksum, None)

    def _emit_block(self, chunk: bytes) -> bytes:
        comp = lz4block.compress_block(chunk, self.level)
        if len(comp) < len(chunk):
            return struct.pack("<I", len(comp)) + comp
        return struct.pack("<I", len(chunk) | 0x80000000) + chunk

    def update(self, chunk: bytes) -> bytes:
        if self._finished:
            raise CompressError("lz4 frame already finished")
        out = bytearray()
        if not self._started:
            out += self._start()
        chunk = bytes(chunk)
        if self._hash is not None:
            self._hash.update(chunk)
        self._buf += chunk
        while len(self._buf) >= self.block_size:
            out += self._emit_block(bytes(self._buf[: self.block_size]))
            del self._buf[: self.block_size]
        return bytes(out)

    def finish(self) -> bytes:
        if self._finished:
            return b""
        out = bytearray()
        if not self._started:
            out += self._start()
        if self._buf:
            out += self._emit_block(bytes(self._buf))
            self._buf.clear()
        out += struct.pack("<I", 0)
        if self._hash is not None:
            out += struct.pack("<I", self._hash.digest())
        self._finished = True
        return bytes(out)
