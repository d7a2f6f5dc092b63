"""Archive writer.

Parity model: ``zpack_writer`` (reference: lib/zpack_write.c; API in
lib/zpack.h:476-632).  Like the reference, the writer has two output
backends — a real file (zpack_init_writer / _cfile) and a growable heap
buffer (zpack_init_writer_heap, lib/zpack_write.c:36-58) — and both a
one-shot (`write_files`) and a streaming (`write_file_stream[_end]`)
compression path.

The section pipeline for a full archive is
``header → data header → files → CDR → EOCDR``
(parity: zpack_write_archive, lib/zpack_write.c:818-829).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import BinaryIO

from . import constants as C
from .codecs import device as codec_device, get_codec
from .codecs.xxh3 import make_xxh3_state, xxh3_64
from .errors import Result, ZPackError
from .format import records
from .utils.observe import metrics


@dataclass
class CompressOptions:
    """Per-file compression choice (parity: zpack_compress_options,
    lib/zpack.h:115-120)."""

    method: C.CompressionMethod = C.CompressionMethod.ZSTD
    level: int | None = None
    #: optional shared zstd dictionary (blob or ZstdDict) — extension
    #: beyond the reference (which passes no dicts to zstd)
    dictionary: object = None

    def resolved_level(self) -> int:
        if self.level is None:
            return C.DEFAULT_LEVELS[C.CompressionMethod(self.method)]
        return self.level


class _FileSink:
    def __init__(self, f: BinaryIO):
        self.f = f

    def write_at(self, offset: int, data: bytes) -> None:
        try:
            self.f.seek(offset)
            self.f.write(data)
        except OSError as e:
            raise ZPackError(Result.ERROR_WRITE_FAILED, str(e)) from e

    def flush(self):
        self.f.flush()


class _HeapSink:
    """Growable in-memory output (parity: the heap branch + pow2 growth
    policy, lib/zpack_common.c:83-105 / zpack_write.c:77-94).  Python's
    bytearray already amortizes growth, so the policy reduces to extend."""

    def __init__(self):
        self.buf = bytearray()

    def write_at(self, offset: int, data: bytes) -> None:
        n = len(self.buf)
        if offset == n:  # pure append (the hot path): one copy, no zero-fill
            self.buf += data
            return
        end = offset + len(data)
        if end > n:
            self.buf.extend(b"\0" * (end - n))
        self.buf[offset:end] = data

    def flush(self):
        pass


class Writer:
    def __init__(self, sink, *, owns_file: bool = False):
        self._sink = sink
        self._owns_file = owns_file
        self.write_offset = 0
        self.file_size = 0
        self.file_entries: list[records.FileEntry] = []
        self.cdr_offset = 0
        self.eocdr_offset = 0
        self.last_return: int | None = None
        self._stream_ctx = None
        self._dictionary = None   # shared zstd dict for subsequent entries
        self._dict_blob = None    # its wire blob (stored as an entry)
        self._dict_written = False

    # -- constructors -------------------------------------------------------

    @classmethod
    def open(cls, path: str | os.PathLike) -> "Writer":
        try:
            f = open(path, "w+b")
        except OSError as e:
            raise ZPackError(Result.ERROR_OPEN_FAILED, str(e)) from e
        return cls(_FileSink(f), owns_file=True)

    @classmethod
    def to_file(cls, f: BinaryIO) -> "Writer":
        return cls(_FileSink(f))

    @classmethod
    def to_heap(cls) -> "Writer":
        return cls(_HeapSink())

    @property
    def buffer(self) -> bytes | None:
        """Heap-mode output bytes (None for file writers)."""
        if isinstance(self._sink, _HeapSink):
            with metrics.phase("writer.buffer", len(self._sink.buf)):
                return bytes(self._sink.buf)
        return None

    @property
    def file_count(self) -> int:
        return len(self.file_entries)

    # -- low-level emit -----------------------------------------------------

    def _emit(self, data: bytes) -> None:
        with metrics.phase("writer.emit", len(data)):
            self._sink.write_at(self.write_offset, data)
        self.write_offset += len(data)
        self.file_size = max(self.file_size, self.write_offset)

    def write_header(self, version: int = C.ARCHIVE_VERSION) -> None:
        """parity: zpack_write_header[_ex], lib/zpack_write.c:60-98."""
        self._emit(records.serialize_header(version))

    def write_data_header(self) -> None:
        """parity: zpack_write_data_header, lib/zpack_write.c:100-123."""
        self._emit(records.serialize_data_header())

    def write_cdr(self, entries: list | None = None) -> None:
        """parity: zpack_write_cdr / _ex (explicit entry list),
        lib/zpack_write.c:713-785 — records cdr_offset for the EOCDR."""
        self.cdr_offset = self.write_offset
        cdr = records.CDR(self.file_entries if entries is None else entries)
        self._emit(cdr.serialize())

    def write_eocdr(self, cdr_offset: int | None = None) -> None:
        """parity: zpack_write_eocdr / _ex (explicit CDR offset),
        lib/zpack_write.c:787-816."""
        self.eocdr_offset = self.write_offset
        self._emit(records.serialize_eocdr(
            self.cdr_offset if cdr_offset is None else cdr_offset))
        self._sink.flush()

    # -- shared dictionary (extension; BASELINE north-star item) -------------

    def set_dictionary(self, blob: bytes) -> None:
        """Attach a shared zstd dictionary: all later zstd entries compress
        against it, and the dictionary itself is stored (uncompressed) as
        the well-known entry ``__zpack.dict`` so readers self-serve.  No
        reference counterpart — ZPack has no dictionary support."""
        from .codecs.zstd.dict import as_dictionary

        self._dict_blob = bytes(blob)
        self._dictionary = as_dictionary(self._dict_blob)
        self._dict_written = False

    def _ensure_dict_entry(self) -> None:
        if self._dictionary is None or self._dict_written:
            return
        self._dict_written = True
        self.add_file(C.DICT_ENTRY_NAME, self._dict_blob,
                      CompressOptions(C.CompressionMethod.NONE))

    def _dict_for(self, options: CompressOptions):
        if int(options.method) != int(C.CompressionMethod.ZSTD):
            return None
        return options.dictionary if options.dictionary is not None else self._dictionary

    # -- one-shot compression path ------------------------------------------

    def write_files(self, files) -> None:
        """Compress and append files (parity: zpack_write_files,
        lib/zpack_write.c:280-343; entry bookkeeping mirrors
        zpack_add_written_file_entry, :241-260).

        ``files``: iterable of (filename, data[, CompressOptions]) tuples or
        dicts with those keys.

        Batches of many files compress + hash on a thread pool (the native
        codec calls release the GIL); serialization stays in entry order.
        The reference is single-threaded by design — parallelism across
        entries is this framework's addition (SURVEY.md §2 north star).
        """
        import os

        batch = [_normalize_file(item) for item in files]
        # Few-but-large groups go per-entry instead: each entry's frame codec
        # parallelizes internally over all cores, whereas the batch call
        # would pin each large entry to a single worker (no nested pools).
        # A device engine also skips the shortcut so codec dispatch (and
        # thus the device pipeline) sees every entry.
        batch_worthy = (
            len(batch) >= 8
            and max(len(d) for _, d, _ in batch) <= (8 << 20)
            and codec_device() is None
            and all(self._dict_for(o) is None for _, _, o in batch)
        )
        if batch_worthy and all(
            int(o.method) in (0, 1, 2) for _, _, o in batch
        ):
            from . import native

            for _, _, o in batch:
                get_codec(o.method)  # enforce codec gates (disabled methods raise)
            datas = [bytes(d) for _, d, _ in batch]
            res = native.compress_batch(
                datas,
                [int(o.method) for _, _, o in batch],
                [o.resolved_level() for _, _, o in batch],
            )
            if res is not None:
                comps, hashes = res
                for (name, _, options), data, comp, h in zip(batch, datas, comps, hashes):
                    offset = self.write_offset
                    self._emit(comp)
                    self.file_entries.append(records.FileEntry(
                        filename=name, offset=offset, comp_size=len(comp),
                        uncomp_size=len(data), hash=h,
                        comp_method=int(options.method)))
                return
        for name, data, options in batch:
            self.add_file(name, data, options)

    def add_file(self, filename: str, data: bytes, options: CompressOptions | None = None) -> records.FileEntry:
        options = options or CompressOptions()
        codec = get_codec(options.method)
        dictionary = self._dict_for(options)
        # Fused fast path for large zstd/lz4 entries: chunk-parallel frames +
        # the entry XXH3 in ONE native call, written straight into the heap
        # buffer — removes the python-side chunk slices, b"".join, separate
        # hash pass and emit copy (~25% of large-entry create time).
        if (dictionary is None
                and int(options.method) in (1, 2)
                and len(data) > (2 << 20)
                and codec_device() is None):
            entry = self._add_file_fused(filename, data, int(options.method),
                                         options.resolved_level())
            if entry is not None:
                return entry
        if dictionary is not None:
            self._ensure_dict_entry()
            comp = codec.compress(bytes(data), options.resolved_level(),
                                  dictionary=dictionary)
        else:
            comp = codec.compress(bytes(data), options.resolved_level())
        offset = self.write_offset
        self._emit(comp)
        with metrics.phase("writer.xxh3", len(data)):
            h = xxh3_64(data)
        entry = records.FileEntry(
            filename=filename,
            offset=offset,
            comp_size=len(comp),
            uncomp_size=len(data),
            hash=h,
            comp_method=int(options.method),
        )
        self.file_entries.append(entry)
        return entry

    def _add_file_fused(self, filename: str, data, method: int,
                        level: int) -> records.FileEntry | None:
        """One-call native chunked compress + hash (see add_file).  Returns
        None when the native backend is unavailable or the sink state does
        not fit the in-place shape — caller falls back to the codec path."""
        from . import native

        if native.get_lib() is None:
            return None
        data = bytes(data)
        n = len(data)
        # Chunk frames stay decode-parallel, but each reset truncates the
        # match window: at Silesia scale 2 MiB zstd chunks measured 5.3%
        # LARGER than libzstd-3's single stream while 8 MiB reaches
        # 0.9972x (round-5 sweep).  LZ4's window is only 64 KiB, so its
        # resets are ~free and 2 MiB keeps maximum parallelism.  zstd
        # chunks are SIZE-adaptive: entries <= 16 MiB keep 2 MiB chunks
        # (an 8 MiB floor left a whole 8 MiB entry on one worker — encode
        # measured 2.6x slower; window loss at that size is ~0.6%), larger
        # entries take 8 MiB (16 MiB at deep levels for the adaptive
        # 32 MiB window).
        if method == int(C.CompressionMethod.LZ4):
            chunk = 2 << 20
        elif n <= (16 << 20):
            chunk = 2 << 20
        else:
            chunk = (8 << 20) if level <= 12 else (16 << 20)
        offset = self.write_offset
        res = native.compress_chunked(method, data, level, chunk)
        if res is None:
            return None
        comp, h = res  # comp: zero-copy view of the native scratch
        size = len(comp)
        self._emit(comp)
        entry = records.FileEntry(
            filename=filename, offset=offset, comp_size=size,
            uncomp_size=n, hash=h, comp_method=method)
        self.file_entries.append(entry)
        return entry

    # -- archive-to-archive copy -------------------------------------------

    def write_files_from_archive(self, reader, entries) -> None:
        """Copy already-compressed bytes verbatim from another archive and
        patch entry offsets — no recompression (parity:
        zpack_write_files_from_archive / zpack_copy_file_entry,
        lib/zpack_write.c:345-428).  This is the primitive behind the CLI's
        add/delete/move commands."""
        for entry in entries:
            raw = reader.read_raw_file(entry)
            offset = self.write_offset
            self._emit(raw)
            self.file_entries.append(
                records.FileEntry(
                    filename=entry.filename,
                    offset=offset,
                    comp_size=entry.comp_size,
                    uncomp_size=entry.uncomp_size,
                    hash=entry.hash,
                    comp_method=entry.comp_method,
                )
            )

    # -- streaming compression path -----------------------------------------

    def write_file_stream_begin(self, filename: str, options: CompressOptions | None = None) -> None:
        """Begin a chunked file write (parity: first zpack_write_file_stream
        call initializing the codec ctx, lib/zpack_write.c:430-531)."""
        if self._stream_ctx is not None:
            raise ZPackError(Result.ERROR_STREAM_INVALID, "stream write already in progress")
        options = options or CompressOptions()
        codec = get_codec(options.method)
        dictionary = self._dict_for(options)
        if dictionary is not None:
            self._ensure_dict_entry()
            compressor = codec.compressor(options.resolved_level(),
                                          dictionary=dictionary)
        else:
            compressor = codec.compressor(options.resolved_level())
        self._stream_ctx = {
            "filename": filename,
            "options": options,
            "compressor": compressor,
            "hash": make_xxh3_state(),
            "offset": self.write_offset,
            "total_in": 0,
            "total_out": 0,
        }

    def write_file_stream(self, chunk: bytes) -> None:
        """Feed one chunk (parity: zpack_write_file_stream,
        lib/zpack_write.c:461-577 — compresses with e_continue semantics and
        rolls the XXH3 state)."""
        ctx = self._stream_ctx
        if ctx is None:
            raise ZPackError(Result.ERROR_STREAM_INVALID, "no stream write in progress")
        chunk = bytes(chunk)
        ctx["hash"].update(chunk)
        out = ctx["compressor"].update(chunk)
        ctx["total_in"] += len(chunk)
        if out:
            ctx["total_out"] += len(out)
            self._emit(out)

    def write_file_stream_end(self) -> records.FileEntry:
        """Flush the codec and append the file entry from stream totals
        (parity: zpack_write_file_stream_end, lib/zpack_write.c:579-685)."""
        ctx = self._stream_ctx
        if ctx is None:
            raise ZPackError(Result.ERROR_STREAM_INVALID, "no stream write in progress")
        out = ctx["compressor"].finish()
        if out:
            ctx["total_out"] += len(out)
            self._emit(out)
        entry = records.FileEntry(
            filename=ctx["filename"],
            offset=ctx["offset"],
            comp_size=ctx["total_out"],
            uncomp_size=ctx["total_in"],
            hash=ctx["hash"].digest(),
            comp_method=int(ctx["options"].method),
        )
        self.file_entries.append(entry)
        self._stream_ctx = None
        return entry

    # -- one-call build ------------------------------------------------------

    def write_archive(self, files) -> None:
        """header → data header → files → CDR → EOCDR
        (parity: zpack_write_archive, lib/zpack_write.c:818-829)."""
        with metrics.phase("writer.write_archive"):
            self.write_header()
            self.write_data_header()
            self.write_files(files)
            with metrics.phase("writer.records"):
                self.write_cdr()
                self.write_eocdr()

    def close(self) -> None:
        if self._owns_file and isinstance(self._sink, _FileSink):
            self._sink.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _normalize_file(item):
    if isinstance(item, dict):
        return item["filename"], item["data"], item.get("options") or CompressOptions()
    if len(item) == 2:
        name, data = item
        return name, data, CompressOptions()
    name, data, options = item
    if options is None:
        options = CompressOptions()
    elif isinstance(options, tuple):
        options = CompressOptions(C.CompressionMethod(options[0]), options[1])
    return name, data, options


def write_archive_to_bytes(files) -> bytes:
    w = Writer.to_heap()
    w.write_archive(files)
    return w.buffer
