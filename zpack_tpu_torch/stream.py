"""Streaming read/write state.

Parity model: ``zpack_stream`` (reference: lib/zpack.h:169-184,
lib/zpack_stream.c:4-29) and the chunked decode path
``zpack_read_file_stream`` (lib/zpack_read.c:473-640).

Contract notes (reference: lib/zpack.h:399-415 and §3.5 of SURVEY.md):
the reference may leave an unconsumed suffix of the input buffer and
report it in ``read_back`` for the caller to re-present at the front of
the next buffer.  Two faces implement that contract here:

- :func:`read_file_stream` — convenience mode; partial input is buffered
  internally so ``read_back`` stays 0 (a legal degenerate).
- :func:`read_file_stream_buffer` — the faithful caller-buffer mode:
  input is consumed only as far as the output budget allows and the
  genuinely-unconsumed suffix is reported in ``read_back`` (nonzero in
  practice; tests/test_stream.py asserts real carries occur, including
  against archives produced by the reference CLI binary).

Completion is ``total_in == comp_size and read_back == 0`` plus drained
output in both modes (see :func:`read_stream_done`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .codecs import get_codec
from .codecs.xxh3 import XXH3State, make_xxh3_state
from .errors import HashMismatchError, Result, StreamStateError, ZPackError


def _make_decompressor(reader, entry):
    """Entry-appropriate decompressor; zstd entries whose frame references
    a dictionary get the archive's shared dict attached (extension — the
    reference has no dictionary support)."""
    codec = get_codec(entry.comp_method)
    if entry.comp_method == 1:  # zstd
        try:
            peek = reader._source.read_at(entry.offset, min(18, entry.comp_size))
            if reader._frame_wants_dict(peek):
                d = reader._load_dictionary()
                if d is not None:
                    return codec.decompressor(dictionary=d)
        except Exception:
            pass
    return codec.decompressor()


@dataclass
class ZPackStream:
    """zlib-style stream object (parity: zpack_stream fields)."""

    next_in: bytes = b""
    avail_in: int = 0
    total_in: int = 0
    next_out: bytearray = field(default_factory=bytearray)
    avail_out: int = 0
    total_out: int = 0
    read_back: int = 0
    xxh3: object = field(default_factory=make_xxh3_state)

    #: caller-buffer mode only: position just past the freshly-read input,
    #: so the caller's carry is next_in[in_pos-read_back:in_pos] → front
    #: (the python face of the reference's advanced next_in pointer,
    #: memmove(in_buf, stream.next_in - stream.read_back, …) in
    #: tests/read_archive.c:56-57 / programs/commands.c:394-397)
    in_pos: int = 0

    # internal decode state (reference keeps the codec ctx on the reader;
    # we keep per-stream state so concurrent streams never collide)
    _decomp: object | None = None
    _stash: bytearray = field(default_factory=bytearray)
    _stash_pos: int = 0
    _entry: object | None = None

    def _stash_left(self) -> int:
        return len(self._stash) - self._stash_pos

    def reset(self) -> None:
        """parity: zpack_reset_stream (lib/zpack_stream.c:14-22)."""
        self.next_in = b""
        self.avail_in = 0
        self.total_in = 0
        self.next_out = bytearray()
        self.avail_out = 0
        self.total_out = 0
        self.read_back = 0
        self.in_pos = 0
        self.xxh3 = make_xxh3_state()
        self._decomp = None
        self._stash = bytearray()
        self._stash_pos = 0
        self._entry = None


def init_stream() -> ZPackStream:
    """parity: zpack_init_stream (lib/zpack_stream.c:4-12)."""
    return ZPackStream()


def read_file_stream(reader, entry, stream: ZPackStream, verify: bool = True) -> bool:
    """One chunked-decode step (parity: zpack_read_file_stream,
    lib/zpack_read.c:515-640).

    Reads up to ``stream.avail_in`` raw bytes from the archive at the
    entry's current position, decodes, and appends at most
    ``stream.avail_out`` bytes to ``stream.next_out`` (cleared first).
    Returns True while more calls are needed; False when the file is done
    (at which point the XXH3 digest has been verified when ``verify``).
    """
    entry = reader._resolve(entry)
    if stream._entry is None:
        stream._entry = entry
        stream._decomp = _make_decompressor(reader, entry)
    elif stream._entry is not entry:
        raise StreamStateError("stream already bound to another entry")
    if stream.avail_out <= 0:
        raise StreamStateError("no output space provided")

    # pull raw bytes only when no decoded output is pending
    if not stream._stash_left() and stream.total_in < entry.comp_size:
        take = min(stream.avail_in or (1 << 20), entry.comp_size - stream.total_in)
        raw = reader._source.read_at(entry.offset + stream.total_in, take)
        if len(raw) < take:
            raise ZPackError(Result.ERROR_FILE_INCOMPLETE, "entry data truncated")
        is_final = stream.total_in + take >= entry.comp_size
        out, _consumed = stream._decomp.decompress(raw, is_final=is_final)
        stream.total_in += take
        stream.read_back = 0
        if out:
            stream.xxh3.update(out)
            stream._stash = bytearray(out)
            stream._stash_pos = 0

    emit = min(stream.avail_out, stream._stash_left())
    p = stream._stash_pos
    stream.next_out = bytearray(stream._stash[p : p + emit])
    stream._stash_pos = p + emit
    stream.total_out += emit

    done = stream.total_in >= entry.comp_size and not stream._stash_left()
    if done:
        if stream.total_out != entry.uncomp_size:
            raise ZPackError(
                Result.ERROR_FILE_SIZE_INVALID,
                f"stream produced {stream.total_out}, expected {entry.uncomp_size}",
            )
        if verify:
            h = stream.xxh3.digest()
            if h != entry.hash:
                raise HashMismatchError(entry.hash, h)
    return not done


def _decode_bounded(stream: ZPackStream, data, avail_out: int, is_final: bool):
    """Feed ``data`` to the stream's codec under an output budget, honestly:
    input is handed to the decoder in pieces only while the decoded output
    fits ``avail_out``; the unfed suffix is returned unconsumed (this is
    what produces nonzero ``read_back`` — parity with the in.pos/srcSizePtr
    semantics of ZSTD_decompressStream / LZ4F_decompress at
    lib/zpack_read.c:572-620).  Decoded-but-unemitted bytes stay in the
    stream stash, which also holds completion (read_stream_done) honest."""
    out = bytearray()
    consumed = 0
    n = len(data)
    while True:
        left = stream._stash_left()
        if left:
            take = min(avail_out - len(out), left)
            p = stream._stash_pos
            out += stream._stash[p : p + take]
            stream._stash_pos = p + take
            if not stream._stash_left():
                stream._stash = bytearray()
                stream._stash_pos = 0
        if len(out) >= avail_out or consumed >= n:
            break
        # feed at most the remaining output budget per piece — and byte-wise
        # once that budget is tiny: near output saturation we must not
        # swallow trailing framing bytes the caller would otherwise get back
        # as read_back (LZ4F stops consuming input once the destination is
        # full; a piece that both completes a block and contains the frame
        # tail would over-consume)
        budget = avail_out - len(out)
        step = 1 if budget <= 256 else min(65536, budget)
        piece = bytes(data[consumed : consumed + step])
        fin = is_final and consumed + len(piece) >= n
        produced, _ = stream._decomp.decompress(piece, is_final=fin)
        consumed += len(piece)
        if produced:
            stream._stash += produced
    return bytes(out), consumed


def read_file_stream_buffer(reader, entry, stream: ZPackStream, verify: bool = True):
    """Caller-buffer streaming decode with the reference's faithful
    ``read_back`` carry contract (lib/zpack.h:179,399-415; decode loop
    lib/zpack_read.c:515-640; caller protocol tests/read_archive.c:52-74).

    The caller owns ``stream.next_in`` — a bytearray used as the input
    buffer — and before each call must (a) move the ``read_back``
    unconsumed bytes to the buffer's front::

        buf[:s.read_back] = buf[s.in_pos - s.read_back : s.in_pos]

    and (b) set ``avail_in`` to the buffer capacity and ``avail_out`` to
    this call's output budget.  The call reads fresh raw bytes from the
    archive into the buffer *after* the carried bytes, decodes at most
    ``avail_out`` bytes into ``stream.next_out``, and reports the
    unconsumed input suffix in ``read_back``.  Completion test is
    :func:`read_stream_done`; the XXH3 digest is verified on completion.
    """
    entry = reader._resolve(entry)
    if entry.comp_size == 0 or read_stream_done(stream, entry):
        stream.next_out = bytearray()
        return
    if stream._entry is None:
        stream._entry = entry
        stream._decomp = _make_decompressor(reader, entry)
    elif stream._entry is not entry:
        raise StreamStateError("stream already bound to another entry")
    if stream.avail_out <= 0:
        raise StreamStateError("no output space provided")
    buf = stream.next_in
    if not isinstance(buf, (bytearray, memoryview)):
        raise StreamStateError("caller-buffer mode needs a bytearray next_in")
    capacity = min(stream.avail_in, len(buf)) if stream.avail_in else len(buf)
    carry = stream.read_back
    if carry > capacity:
        raise StreamStateError("read_back exceeds input buffer")
    # fresh raw bytes land after the carried ones (zpack_read_raw_file_stream
    # advances next_in past them, lib/zpack_read.c:501-505)
    take = min(capacity - carry, entry.comp_size - stream.total_in)
    if take:
        raw = reader._source.read_at(entry.offset + stream.total_in, take)
        if len(raw) < take:
            raise ZPackError(Result.ERROR_FILE_INCOMPLETE, "entry data truncated")
        buf[carry : carry + take] = raw
        stream.total_in += take
    in_size = carry + take
    stream.in_pos = in_size
    is_final = stream.total_in >= entry.comp_size
    out, consumed = _decode_bounded(
        stream, memoryview(buf)[:in_size], stream.avail_out, is_final
    )
    stream.read_back = in_size - consumed
    if out:
        stream.xxh3.update(out)
    stream.next_out = bytearray(out)
    stream.total_out += len(out)
    if read_stream_done(stream, entry):
        if stream.total_out != entry.uncomp_size:
            raise ZPackError(
                Result.ERROR_FILE_SIZE_INVALID,
                f"stream produced {stream.total_out}, expected {entry.uncomp_size}",
            )
        if verify:
            h = stream.xxh3.digest()
            if h != entry.hash:
                raise HashMismatchError(entry.hash, h)


def read_raw_file_stream(reader, entry, stream: ZPackStream) -> bool:
    """Chunked *raw* (still-compressed) reads of an entry
    (parity: zpack_read_raw_file_stream, lib/zpack_read.c:473-513): each
    call fills ``stream.next_out`` with up to ``avail_out`` compressed
    bytes from the entry's data; returns True while more remain."""
    entry = reader._resolve(entry)
    if stream._entry is None:
        stream._entry = entry
    elif stream._entry is not entry:
        raise StreamStateError("stream already bound to another entry")
    if stream.avail_out <= 0:
        raise StreamStateError("no output space provided")
    take = min(stream.avail_out, entry.comp_size - stream.total_in)
    raw = reader._source.read_at(entry.offset + stream.total_in, take) if take else b""
    if len(raw) < take:
        raise ZPackError(Result.ERROR_FILE_INCOMPLETE, "entry data truncated")
    stream.next_out = bytearray(raw)
    stream.total_in += take
    stream.total_out += take
    return stream.total_in < entry.comp_size


def read_stream_done(stream: ZPackStream, entry) -> bool:
    """parity: ZPACK_READ_STREAM_DONE (lib/zpack.h:713-714)."""
    return (
        stream.total_in >= entry.comp_size
        and stream.read_back == 0
        and not stream._stash_left()
    )


def read_file_stream_iter(reader, entry, chunk_size: int = 1 << 20, verify: bool = True):
    """Generator face of the streaming decode: yields decompressed chunks
    (bounded memory for store/lz4; zstd currently frames-buffered)."""
    stream = init_stream()
    stream.avail_in = chunk_size
    stream.avail_out = max(chunk_size, 1)
    if entry.comp_size == 0:
        if entry.uncomp_size != 0:
            raise ZPackError(Result.ERROR_FILE_SIZE_INVALID, "empty data, nonzero size")
        return
    more = True
    while more:
        more = read_file_stream(reader, entry, stream, verify)
        if stream.next_out:
            yield bytes(stream.next_out)


# Codec-derived stream buffer hints.  Our zstd codec works in 128 KiB
# blocks (RFC 8878 max block size, same granularity libzstd's
# ZSTD_CStreamInSize/ZSTD_DStreamInSize report); our lz4 frame codec emits
# 64 KiB blocks (the reference hardcodes 64 KiB / LZ4F_compressBound(0)).
_ZSTD_BLOCK = 128 << 10
_ZSTD_BLOCK_HDR = 3
_LZ4_BLOCK = 64 << 10


def _lz4f_one_block_bound() -> int:
    # one worst-case 64 KiB lz4f block: 4-byte block header + incompressible
    # payload, plus frame header (≤19) and end mark + checksum (8)
    return _LZ4_BLOCK + 4 + 19 + 8


def _zstd_one_block_bound() -> int:
    # raw-block fallback bounds a block's cost: 3-byte header + payload,
    # plus frame header (≤18) and checksum (4)
    return _ZSTD_BLOCK + _ZSTD_BLOCK_HDR + 18 + 4


def _hint(method: int, zstd_val: int, lz4_val: int) -> int:
    """Reference behavior (lib/zpack_read.c:719-758): method NONE falls
    through to the largest available codec's value; disabled codecs drop
    out of the chain; unknown methods return 0."""
    from . import constants as C
    from .codecs import _disabled

    m = int(method)
    zstd_ok = not _disabled(C.CompressionMethod.ZSTD)
    lz4_ok = not _disabled(C.CompressionMethod.LZ4)
    if m == int(C.CompressionMethod.LZ4):
        return lz4_val if lz4_ok else 0
    if m == int(C.CompressionMethod.ZSTD):
        return zstd_val if zstd_ok else 0
    if m == int(C.CompressionMethod.NONE):
        return zstd_val if zstd_ok else (lz4_val if lz4_ok else 0)
    return 0


def recommended_cstream_in_size(method: int) -> int:
    """parity: zpack_get_cstream_in_size (lib/zpack_write.c:858-874)."""
    return _hint(method, _ZSTD_BLOCK, _LZ4_BLOCK)


def recommended_cstream_out_size(method: int) -> int:
    """parity: zpack_get_cstream_out_size (lib/zpack_write.c:880-897)."""
    return _hint(method, _zstd_one_block_bound(), _lz4f_one_block_bound())


def recommended_dstream_in_size(method: int) -> int:
    """parity: zpack_get_dstream_in_size (lib/zpack_read.c:719-737)."""
    return _hint(method, _ZSTD_BLOCK + _ZSTD_BLOCK_HDR, _lz4f_one_block_bound())


def recommended_dstream_out_size(method: int) -> int:
    """parity: zpack_get_dstream_out_size (lib/zpack_read.c:740-758)."""
    return _hint(method, _ZSTD_BLOCK, _LZ4_BLOCK)
