"""Bitstream primitives for the zstd format (RFC 8878).

zstd uses two bitstream flavors:
  * forward LSB-first streams (FSE table descriptions), and
  * backward streams (Huffman literals, FSE sequences) terminated by a
    1-bit sentinel in the final byte, read from the end toward the start.

Role parity: the bit-level machinery inside the reference's vendored zstd
(externals/zstd) that ZSTD_decompressDCtx/ZSTD_compressCCtx rely on
(called from lib/zpack_read.c:380 and lib/zpack_write.c:179).
"""

from __future__ import annotations

from ..errors import DecompressError


class ForwardBitReader:
    """LSB-first forward reader (FSE table descriptions, RFC 8878 §4.1.1)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bitpos = pos * 8

    def read(self, nbits: int) -> int:
        v = self.peek(nbits)
        self.bitpos += nbits
        return v

    def peek(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        start = self.bitpos >> 3
        end = (self.bitpos + nbits + 7) >> 3
        chunk = self.data[start:end]
        if len(chunk) < end - start:
            chunk = chunk + b"\0" * (end - start - len(chunk))
        word = int.from_bytes(chunk, "little")
        return (word >> (self.bitpos & 7)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        self.bitpos += nbits

    @property
    def byte_pos(self) -> int:
        """Bytes consumed, rounding the current bit position up."""
        return (self.bitpos + 7) >> 3


class BackwardBitReader:
    """Backward reader for Huffman/sequence payloads (RFC 8878 §3.1.1.3.2.1):
    the last byte carries a high sentinel 1-bit; reads pull the highest
    remaining bits, moving toward the start of the buffer."""

    def __init__(self, data: bytes):
        if not data:
            raise DecompressError("empty backward bitstream")
        last = data[-1]
        if last == 0:
            raise DecompressError("corrupt backward bitstream (no sentinel)")
        self.data = data
        self.bits_left = (len(data) - 1) * 8 + (last.bit_length() - 1)

    def read(self, nbits: int) -> int:
        """Read ``nbits`` (0..57); reading past the start yields zero bits
        (matching the reference's defined overflow behavior for FSE init)."""
        if nbits == 0:
            return 0
        self.bits_left -= nbits
        pos = self.bits_left
        if pos >= 0:
            start = pos >> 3
            end = (pos + nbits + 7) >> 3
            word = int.from_bytes(self.data[start:end], "little")
            return (word >> (pos & 7)) & ((1 << nbits) - 1)
        # overflowed: valid streams only hit this transiently; zeros fill
        avail = nbits + pos
        if avail <= 0:
            return 0
        end = (avail + 7) >> 3
        word = int.from_bytes(self.data[0:end], "little")
        return (word & ((1 << avail) - 1)) << (-pos)

    @property
    def finished(self) -> bool:
        return self.bits_left == 0

    @property
    def overflowed(self) -> bool:
        return self.bits_left < 0


class BackwardBitWriter:
    """Builds a backward bitstream: values are appended LSB-first and the
    sentinel bit closes the stream; the decoder then reads them in reverse
    append order."""

    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def finish(self) -> bytes:
        # sentinel closing bit
        self._acc |= 1 << self._nbits
        self._nbits += 1
        while self._nbits > 0:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8
        return bytes(self._out)


def highbit(v: int) -> int:
    if v <= 0:
        raise ValueError("highbit of non-positive value")
    return v.bit_length() - 1
