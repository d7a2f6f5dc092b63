"""Archive reader.

Parity model: ``zpack_reader`` and its init/open paths
(reference: lib/zpack_read.c:225-296,642-713; API in lib/zpack.h:335-472).

Init modes mirror the reference's four:
  * :meth:`Reader.open` — from a path (zpack_init_reader, lib/zpack_read.c:642)
  * :meth:`Reader.from_file` — from an open binary file object
    (zpack_init_reader_cfile, lib/zpack_read.c:656)
  * :meth:`Reader.from_memory` with ``shared=False`` — copies the buffer
    (zpack_init_reader_memory, lib/zpack_read.c:663)
  * :meth:`Reader.from_memory` with ``shared=True`` — zero-copy view
    (zpack_init_reader_memory_shared, lib/zpack_read.c:672)

Thread-safety contract matches the reference (lib/zpack.h:335-341):
memory-backed readers are safe for concurrent reads; file-backed are not.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Iterable

from . import constants as C
from .codecs import get_codec
from .codecs.xxh3 import xxh3_64
from .errors import (
    DecompressError,
    FileNotFoundInArchiveError,
    FileTooSmallError,
    HashMismatchError,
    Result,
    TruncatedError,
    ZPackError,
)
from .format import records
from .utils.observe import metrics


class _FileSource:
    def __init__(self, f: BinaryIO):
        self.f = f

    def size(self) -> int:
        pos = self.f.tell()
        self.f.seek(0, os.SEEK_END)
        n = self.f.tell()
        self.f.seek(pos)
        return n

    def read_at(self, offset: int, size: int) -> bytes:
        try:
            self.f.seek(offset)
        except (OSError, ValueError) as e:
            raise ZPackError(Result.ERROR_SEEK_FAILED, str(e)) from e
        return self.f.read(size)


class _MemorySource:
    def __init__(self, buf):
        self.buf = memoryview(buf)

    def size(self) -> int:
        return len(self.buf)

    def read_at(self, offset: int, size: int) -> bytes:
        return bytes(self.buf[offset : offset + size])

    def bytes_base(self):
        """The underlying ``bytes`` object when the source wraps one —
        lets large-entry decode run in place over the archive buffer
        (no compressed-slice copy).  Only returned when the view spans the
        whole object: entry offsets are relative to the view, so a
        nonzero-offset slice would alias them onto the wrong base."""
        obj = self.buf.obj
        return obj if type(obj) is bytes and len(self.buf) == len(obj) else None


class Reader:
    def __init__(self, source, *, owns_file: bool = False, shared: bool = False):
        self._source = source
        self._owns_file = owns_file
        self.buffer_shared = shared
        self.version: int = 0
        self.file_entries: list[records.FileEntry] = []
        self.comp_size = 0
        self.uncomp_size = 0
        self.file_size = 0
        self.cdr_offset = 0
        self.eocdr_offset = 0
        self.last_return: int | None = None
        self._name_index: dict | None = None
        self._dict = None          # attached/loaded shared zstd dictionary
        self._dict_loaded = False  # (lazy; loading guards against recursion)
        with metrics.phase("reader.open"):
            self._read_archive()

    # -- constructors -------------------------------------------------------

    @classmethod
    def open(cls, path: str | os.PathLike) -> "Reader":
        try:
            f = open(path, "rb")
        except OSError as e:
            raise ZPackError(Result.ERROR_OPEN_FAILED, str(e)) from e
        return cls(_FileSource(f), owns_file=True)

    @classmethod
    def from_file(cls, f: BinaryIO) -> "Reader":
        return cls(_FileSource(f))

    @classmethod
    def from_memory(cls, buf, shared: bool = False) -> "Reader":
        if not shared:
            buf = bytes(buf)
        return cls(_MemorySource(buf), shared=shared)

    # -- open sequence ------------------------------------------------------

    def _read_archive(self) -> None:
        """Full open sequence: header → data signature → EOCDR at
        file_size-12 → CDR (parity: zpack_read_archive, lib/zpack_read.c:262
        and spec reading order docs/specs.md:28-32)."""
        self.file_size = self._source.size()
        if self.file_size < C.MINIMUM_ARCHIVE_SIZE:
            raise FileTooSmallError(self.file_size)
        head = self._source.read_at(0, C.HEADER_SIZE + C.SIGNATURE_SIZE)
        if len(head) < C.HEADER_SIZE + C.SIGNATURE_SIZE:
            raise TruncatedError("archive head truncated")
        self.version = records.parse_header(head, 0)
        records.parse_data_header(head, C.HEADER_SIZE)
        self.eocdr_offset = self.file_size - C.EOCDR_SIZE
        eocdr = self._source.read_at(self.eocdr_offset, C.EOCDR_SIZE)
        self.cdr_offset = records.parse_eocdr(eocdr, 0)
        if self.cdr_offset + C.CDR_HEADER_SIZE > self.file_size:
            raise ZPackError(Result.ERROR_SEEK_FAILED, "CDR offset beyond file")
        cdr_head = self._source.read_at(self.cdr_offset, C.CDR_HEADER_SIZE)
        file_count, block_size = records.parse_cdr_header(cdr_head, 0)
        # Sanity: CDR block must fit between its header and the EOCDR
        # (parity: block-size validation, lib/zpack_read.c:199-210).
        if self.cdr_offset + C.CDR_HEADER_SIZE + block_size > self.eocdr_offset:
            raise ZPackError(Result.ERROR_BLOCK_SIZE_INVALID, "CDR block overruns EOCDR")
        block = self._source.read_at(self.cdr_offset + C.CDR_HEADER_SIZE, block_size)
        if len(block) < block_size:
            raise TruncatedError("CDR block truncated")
        self.file_entries, self.comp_size, self.uncomp_size = records.parse_file_entries(
            block, file_count
        )

    # -- queries ------------------------------------------------------------

    @property
    def file_count(self) -> int:
        return len(self.file_entries)

    def get_file_entry(self, filename: str) -> records.FileEntry:
        """Filename lookup (parity: zpack_get_file_entry,
        lib/zpack_read.c:760-769 — the reference scans linearly; we build a
        lazy index so 10k-entry archives stay O(1) per lookup)."""
        if self._name_index is None:
            self._name_index = {}
            for e in self.file_entries:
                self._name_index.setdefault(e.filename, e)
        e = self._name_index.get(filename)
        if e is None:
            raise FileNotFoundInArchiveError(filename)
        return e

    def __iter__(self) -> Iterable[records.FileEntry]:
        return iter(self.file_entries)

    # -- data access --------------------------------------------------------

    def _resolve(self, entry) -> records.FileEntry:
        if isinstance(entry, records.FileEntry):
            return entry
        return self.get_file_entry(entry)

    def _read_lz4_inplace(self, base: bytes, e) -> bytes | None:
        """Frame-parallel lz4 decode straight out of the archive buffer.
        None when the entry isn't concatenated content-sized frames (the
        caller falls back to the copying path)."""
        from . import native
        from .parallel import host

        with metrics.phase("reader.lz4_scan", e.comp_size):
            try:
                bounds = host._scan_lz4f_frames(base, e.offset, e.offset + e.comp_size)
            except Exception:
                return None
            if not bounds or len(bounds) < 2:
                return None
            if sum(b[2] for b in bounds) != e.uncomp_size:
                return None
        with metrics.phase("lz4.decompress", e.uncomp_size):
            metrics.count("lz4.decompress.host", nbytes=e.uncomp_size)
            return native.lz4f_decompress_frames(base, bounds)

    def read_raw_file(self, entry) -> bytes:
        """Read an entry's raw (compressed) bytes
        (parity: zpack_read_raw_file, lib/zpack_read.c:298-340)."""
        e = self._resolve(entry)
        if e.offset + e.comp_size > self.file_size:
            raise ZPackError(Result.ERROR_FILE_OFFSET_INVALID, "entry data beyond file")
        with metrics.phase("reader.slice", e.comp_size):
            data = self._source.read_at(e.offset, e.comp_size)
        if len(data) < e.comp_size:
            raise ZPackError(Result.ERROR_FILE_INCOMPLETE, "entry data truncated")
        return data

    # -- shared dictionary (extension; BASELINE north-star item) -------------

    def attach_dictionary(self, blob: bytes) -> None:
        """Explicitly attach a zstd dictionary (structured or raw-content)
        for entries whose frames reference one."""
        from .codecs.zstd.dict import as_dictionary

        self._dict = as_dictionary(blob)
        self._dict_loaded = True

    @staticmethod
    def _frame_wants_dict(raw: bytes) -> bool:
        """Cheap peek: does the first zstd frame carry a nonzero dict_id?"""
        try:
            from .codecs.zstd import frame as zframe
            import struct as _s

            if len(raw) < 5 or _s.unpack_from("<I", raw, 0)[0] != zframe.MAGIC:
                return False
            return zframe.parse_frame_header(raw[4:22], 0).dict_id != 0
        except Exception:
            return False

    def _load_dictionary(self):
        """The archive's shared dictionary: an explicitly attached one, or
        the well-known ``__zpack.dict`` entry (loaded lazily, once)."""
        if self._dict_loaded:
            return self._dict
        self._dict_loaded = True  # set first: read_file below must not recurse
        if self._name_index is None:
            self._name_index = {}
            for e in self.file_entries:
                self._name_index.setdefault(e.filename, e)
        e = self._name_index.get(C.DICT_ENTRY_NAME)
        if e is not None:
            from .codecs.zstd.dict import as_dictionary

            self._dict = as_dictionary(self.read_file(e))
        return self._dict

    def read_file(self, entry, verify: bool = True) -> bytes:
        """Decompress one entry; always verifies the XXH3-64 hash unless
        ``verify=False`` (parity: zpack_read_file always verifies,
        lib/zpack_read.c:466-468)."""
        e = self._resolve(entry)
        with metrics.phase("reader.read_file", e.uncomp_size):
            return self._read_entry(e, verify)

    def _verify(self, e, out: bytes) -> None:
        with metrics.phase("reader.xxh3", len(out)):
            h = xxh3_64(out)
        if h != e.hash:
            raise HashMismatchError(e.hash, h)

    def _read_entry(self, e: records.FileEntry, verify: bool) -> bytes:
        # plausibility bound: no supported codec expands beyond ~1e6x
        # (zstd RLE blocks peak near 5e5x); a corrupt uncomp_size field must
        # not drive giant allocations before the size/hash checks fire.
        # This must precede EVERY decode path, including the in-place
        # fast path below (whose frame scan trusts declared content sizes).
        if e.comp_size and e.uncomp_size > e.comp_size * 1_000_000 + (1 << 20):
            raise ZPackError(
                Result.ERROR_FILE_SIZE_INVALID,
                f"implausible uncompressed size {e.uncomp_size} for {e.comp_size} compressed bytes",
            )
        # zero-copy fast path: large multi-frame lz4 entries of an in-memory
        # archive decode IN PLACE over the archive buffer (frame-parallel,
        # no compressed-slice copy — the copy alone costs ~25% of the
        # decode time on an 8 MB entry)
        if (e.comp_method == int(C.CompressionMethod.LZ4)
                and e.comp_size > (1 << 20)
                and e.offset + e.comp_size <= self.file_size):
            base = getattr(self._source, "bytes_base", lambda: None)()
            if base is not None:
                get_codec(e.comp_method)  # enforce codec gates
                out = self._read_lz4_inplace(base, e)
                if out is not None:
                    if verify:
                        self._verify(e, out)
                    return out
        raw = self.read_raw_file(e)
        codec = get_codec(e.comp_method)
        if (e.comp_method == int(C.CompressionMethod.ZSTD)
                and e.filename != C.DICT_ENTRY_NAME and self._frame_wants_dict(raw)):
            d = self._load_dictionary()
            if d is None:
                raise ZPackError(
                    Result.ERROR_DECOMPRESS_FAILED,
                    "entry requires a shared dictionary but none is attached "
                    "or stored in the archive")
            out = codec.decompress(raw, e.uncomp_size, dictionary=d)
        else:
            try:
                out = codec.decompress(raw, e.uncomp_size)
            except DecompressError:
                # raw-content dicts leave dict_id == 0: retry with the
                # archive dictionary before giving up
                d = (self._load_dictionary()
                     if e.comp_method == int(C.CompressionMethod.ZSTD)
                     and e.filename != C.DICT_ENTRY_NAME else None)
                if d is None:
                    raise
                out = codec.decompress(raw, e.uncomp_size, dictionary=d)
        if len(out) != e.uncomp_size:
            raise ZPackError(
                Result.ERROR_FILE_SIZE_INVALID,
                f"decompressed size {len(out)} != recorded {e.uncomp_size}",
            )
        if verify:
            self._verify(e, out)
        return out

    def read_files(self, entries=None, verify: bool = True) -> list[bytes]:
        """Decompress + verify many entries at once.  Uses the native batch
        path (one FFI call, parallel worker threads — the read-side of the
        batched writer) when every entry is store/zstd/lz4; falls back to
        per-entry :meth:`read_file`.  The reference is single-threaded by
        design; batch reads are this framework's addition."""
        ents = [self._resolve(e) for e in (entries if entries is not None else self.file_entries)]
        results: dict[int, bytes] = {}
        # dict-bearing archives: zstd entries may need the shared dictionary,
        # which the native batch codec doesn't know — per-entry path handles it
        has_dict = (self._dict is not None
                    or any(e.filename == C.DICT_ENTRY_NAME for e in self.file_entries))
        if (verify and len(ents) >= 4 and all(e.comp_method in (0, 1, 2) for e in ents)
                and not (has_dict and any(e.comp_method == 1 for e in ents))):
            from . import native

            for e in ents:
                get_codec(e.comp_method)  # enforce codec gates
                if e.offset + e.comp_size > self.file_size:
                    raise ZPackError(Result.ERROR_FILE_OFFSET_INVALID, "entry data beyond file")
                if e.comp_size and e.uncomp_size > e.comp_size * 1_000_000 + (1 << 20):
                    raise ZPackError(Result.ERROR_FILE_SIZE_INVALID, "implausible uncompressed size")
            # Group offset-adjacent entries into capped native calls: the
            # aggregate output allocation stays bounded (a crafted CDR with
            # many overlapping entries must not force one multi-GB np.empty)
            # and source reads touch O(selected bytes) — selecting 2 distant
            # entries of a huge archive never materializes the span between.
            OUT_CAP = 128 << 20
            GAP_CAP = 1 << 20
            order = sorted(range(len(ents)), key=lambda i: ents[i].offset)
            groups: list[list[int]] = []
            cur: list[int] = []
            cur_out = 0
            cur_hi = 0
            for i in order:
                e = ents[i]
                if cur and (cur_out + e.uncomp_size > OUT_CAP or e.offset - cur_hi > GAP_CAP):
                    groups.append(cur)
                    cur, cur_out, cur_hi = [], 0, 0
                cur.append(i)
                cur_out += e.uncomp_size
                cur_hi = max(cur_hi, e.offset + e.comp_size)
            if cur:
                groups.append(cur)
            for g in groups:
                if len(g) < 2:
                    continue  # single entry: per-entry path below
                ge = [ents[i] for i in g]
                lo = min(e.offset for e in ge)
                hi = max(e.offset + e.comp_size for e in ge)
                buf = self._source.read_at(lo, hi - lo)
                if len(buf) != hi - lo:
                    continue
                try:
                    res = native.decompress_batch(
                        bytes(buf),
                        [e.offset - lo for e in ge],
                        [e.comp_size for e in ge],
                        [e.comp_method for e in ge],
                        [e.uncomp_size for e in ge],
                        [e.hash for e in ge],
                    )
                except MemoryError:
                    res = None
                if res is None:
                    continue
                outs, mask = res
                for i, o, m in zip(g, outs, mask):
                    if not m:  # failed entries re-run through read_file so
                        results[i] = o  # callers get the exact error
        return [results[i] if i in results else self.read_file(e, verify=verify)
                for i, e in enumerate(ents)]

    def extract_iter(self, entry, chunk_size: int = 1 << 20, verify: bool = True):
        """Chunked decode generator (TPU-pythonic face of the reference's
        zpack_read_file_stream, lib/zpack_read.c:473-640)."""
        from .stream import read_file_stream_iter

        yield from read_file_stream_iter(self, self._resolve(entry), chunk_size, verify)

    def close(self) -> None:
        if self._owns_file and isinstance(self._source, _FileSource):
            self._source.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_archive_memory(buf, shared: bool = False) -> Reader:
    return Reader.from_memory(buf, shared=shared)
