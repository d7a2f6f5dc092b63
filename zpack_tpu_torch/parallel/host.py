"""Host-parallel chunked compression.

The native codec calls run through ctypes, which releases the GIL — so
independent chunks compress/decompress on real OS threads across host
cores.  Chunks become *separate frames* (zstd) or independent-block frame
segments (lz4f): spec-valid concatenations that any conformant decoder
streams through, and the same chunk independence the TPU mesh pipeline
and multi-host sharding rely on (BASELINE config 5: blocks sharded
data-parallel across hosts — each host compresses its chunk range, host 0
concatenates in order).
"""

from __future__ import annotations

import concurrent.futures as cf
import os

from .. import native

DEFAULT_CHUNK = 8 << 20


def _workers(explicit: int | None) -> int:
    if explicit:
        return explicit
    return max(1, min(8, os.cpu_count() or 1))


def zstd_compress_parallel(data: bytes, level: int = 3, *, chunk: int = DEFAULT_CHUNK,
                           workers: int | None = None) -> bytes | None:
    """Compress as one zstd frame per chunk, chunks in parallel threads.
    Returns None when the native backend is unavailable."""
    if native.get_lib() is None:
        return None
    data = bytes(data)
    if len(data) <= chunk:
        return native.zstd_compress(data, level)
    parts = [data[i : i + chunk] for i in range(0, len(data), chunk)]
    with cf.ThreadPoolExecutor(max_workers=_workers(workers)) as ex:
        frames = list(ex.map(lambda p: native.zstd_compress(p, level), parts))
    if any(f is None for f in frames):
        return None
    return b"".join(frames)


def zstd_decompress_parallel(data: bytes, sizes: list[int] | None = None, *,
                             workers: int | None = None) -> bytes | None:
    """Decompress concatenated zstd frames in parallel by scanning frame
    boundaries (content sizes must be present, as our encoder guarantees)."""
    if native.get_lib() is None:
        return None
    bounds = _scan_zstd_frames(data)
    if bounds is None:
        return None
    with cf.ThreadPoolExecutor(max_workers=_workers(workers)) as ex:
        outs = list(
            ex.map(lambda se: native.zstd_decompress(data[se[0] : se[1]], se[2]), bounds)
        )
    if any(o is None for o in outs):
        return None
    return b"".join(outs)


def _scan_zstd_frames(data: bytes):
    """Return [(start, end, content_size)] for concatenated frames, or None
    if any frame lacks a declared content size / looks unfamiliar."""
    import struct

    from ..codecs.zstd import frame as zf

    bounds = []
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < 4:
            return None
        (magic,) = struct.unpack_from("<I", data, pos)
        if zf.MAGIC_SKIPPABLE_MIN <= magic <= zf.MAGIC_SKIPPABLE_MAX:
            (size,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != zf.MAGIC:
            return None
        start = pos
        try:
            hdr = zf.parse_frame_header(data, pos + 4)
        except Exception:
            return None
        if hdr.content_size is None:
            return None
        p = pos + 4 + hdr.header_size
        while True:
            if n - p < 3:
                return None
            bh = data[p] | (data[p + 1] << 8) | (data[p + 2] << 16)
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            p += 3 + (1 if btype == zf.BLOCK_RLE else bsize)
            if last:
                break
        if hdr.has_checksum:
            p += 4
        bounds.append((start, p, hdr.content_size))
        pos = p
    return bounds


def lz4f_compress_parallel(data: bytes, level: int = 1, *, chunk: int = DEFAULT_CHUNK,
                           workers: int | None = None) -> bytes | None:
    """One lz4 frame per chunk, compressed in parallel threads."""
    if native.get_lib() is None:
        return None
    data = bytes(data)
    if len(data) <= chunk:
        return native.lz4f_compress(data, level)
    parts = [data[i : i + chunk] for i in range(0, len(data), chunk)]
    with cf.ThreadPoolExecutor(max_workers=_workers(workers)) as ex:
        frames = list(ex.map(lambda p: native.lz4f_compress(p, level), parts))
    if any(f is None for f in frames):
        return None
    return b"".join(frames)


def _scan_lz4f_frames(data: bytes, start: int = 0, end: int | None = None):
    """Return [(start, end, content_size)] for concatenated lz4 frames with
    declared content sizes (our native encoder always declares them), or
    None when any frame lacks one / looks unfamiliar.  ``start``/``end``
    bound the scan region (offsets stay absolute into ``data``), letting an
    archive reader scan one entry's span in place."""
    import struct

    from ..codecs.lz4 import frame as lf

    bounds = []
    pos = start
    n = len(data) if end is None else end
    while pos < n:
        if n - pos < 4:
            return None
        (magic,) = struct.unpack_from("<I", data, pos)
        if lf.MAGIC_SKIPPABLE_MIN <= magic <= lf.MAGIC_SKIPPABLE_MAX:
            if n - pos < 8:
                return None
            (size,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != lf.MAGIC:
            return None
        start = pos
        if n - pos < 7:
            return None
        flg = data[pos + 4]
        if (flg >> 6) != 1 or not (flg & 0x08):
            return None  # no declared content size: sequential path
        b_chk = bool(flg & 0x10)
        c_chk = bool(flg & 0x04)
        desc_len = 2 + 8 + (4 if flg & 0x01 else 0)
        if n - pos < 4 + desc_len + 1:
            return None
        (content_size,) = struct.unpack_from("<Q", data, pos + 6)
        p = pos + 4 + desc_len + 1
        while True:
            if n - p < 4:
                return None
            (bh,) = struct.unpack_from("<I", data, p)
            p += 4
            if bh == 0:
                break
            p += (bh & 0x7FFFFFFF) + (4 if b_chk else 0)
            if p > n:
                return None
        if c_chk:
            p += 4
        if p > n:
            return None
        bounds.append((start, p, content_size))
        pos = p
    return bounds


def lz4f_decompress_parallel(data: bytes, max_out: int | None = None, *,
                             workers: int | None = None) -> bytes | None:
    """Decompress concatenated lz4 frames in parallel (frames carry their
    content size).  None when unavailable/unsuitable — callers fall back to
    the sequential native path."""
    if native.get_lib() is None:
        return None
    bounds = _scan_lz4f_frames(data)
    if bounds is None or len(bounds) < 2:
        return None
    total = sum(b[2] for b in bounds)
    if max_out is not None and total > max_out:
        return None
    return native.lz4f_decompress_frames(data, bounds)
