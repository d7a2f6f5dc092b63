"""The comparison that decides ``correct``.

The reference knows only what the benchmark made: each entry's content,
generated from the seed, and the archive's layout in the format's terms.
From those it works out every record, every entry's XXH3-64 and the
content of every block, and holds the program's archives and reads to
them.  It imports nothing of the program.

The counts it takes:

* ``records_wrong``: archives whose header, data signature, CDR, EOCDR,
  entry list (names, order, sizes, method) or layout is wrong;
* ``hashes_wrong``: CDR hashes that differ from the reference XXH3-64;
* ``frames_wrong``: entries whose frames are malformed or hold the wrong
  number of blocks for their size;
* ``blocks_wrong``: sampled LZ4 blocks, or zstd frames, that the reference
  decodes to anything but the entry's bytes at that place;
* ``reads_wrong``: sampled reads whose bytes differ from the entry's;
* ``read_sizes_wrong``: reads of the wrong length (every read);
* ``ops_failed``: operations of the window that raised.

The numbers compared (:func:`compared`) are three sums of them, one for
each thing the timed path produces: ``archive_faults`` (records, hashes,
frames), ``blocks_wrong``, ``read_faults`` (reads, read sizes, failed
operations).  Every one counts faults, so each limit is 0.
"""

from __future__ import annotations

import struct

import numpy as np

from . import archive as zarc
from . import lz4 as zlz4
from .errors import DecompressError
from .xxhash import xxh3_64
from .zstd import frame as zframe

LIMITS = {"archive_faults": 0, "blocks_wrong": 0, "read_faults": 0}
PARTS = {"archive_faults": ("records_wrong", "hashes_wrong", "frames_wrong"),
         "blocks_wrong": ("blocks_wrong",),
         "read_faults": ("reads_wrong", "read_sizes_wrong", "ops_failed")}

ZSTD_MAGIC = 0xFD2FB528


def reference_hashes(contents: dict) -> dict:
    return {name: xxh3_64(data) for name, data in contents.items()}


def zstd_frames(data: bytes):
    """``(start, end, content_pos, content_size)`` a frame of an entry's
    zstd frames, by their headers and block headers; content_pos is None
    after a frame that does not state its size."""
    out = []
    pos, n, at = 0, len(data), 0
    while pos < n:
        (magic,) = struct.unpack_from("<I", data, pos)
        if magic != ZSTD_MAGIC:
            raise DecompressError(f"bad zstd magic {magic:#x}")
        start = pos
        head = zframe.parse_frame_header(data, pos + 4)
        pos += 4 + head.header_size
        while True:
            bh = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16
            pos += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
            if (bh >> 1) & 3 == 3:
                raise DecompressError("reserved block type")
            if bh & 1:
                break
        pos += 4 if head.has_checksum else 0
        if pos > n:
            raise DecompressError("truncated frame")
        out.append((start, pos, at, head.content_size))
        at = None if at is None or head.content_size is None else at + head.content_size
    return out


def _lz4_units(data: bytes, size: int):
    """``(block, block maximum)`` for each block of an LZ4 entry whose place
    is known, and whether its frames are sound for an entry of ``size``
    bytes: in a single frame every block but the last is full, so the count
    of blocks and each stored block's size follow from the size."""
    frames, faults = zlz4.walk(data)
    if faults:
        return [], False
    units = [(b, f.bmax) for f in frames for b in f.blocks if b.out_pos is not None]
    if len(frames) == 1:
        f = frames[0]
        if len(f.blocks) != -(-size // f.bmax):
            return units, False
        if any(not b.compressed and b.size != min(f.bmax, size - b.out_pos) for b in f.blocks):
            return units, False
    return units, True


def _lz4_block_ok(data: bytes, block, content: bytes, bmax: int) -> bool:
    want = content[block.out_pos:block.out_pos + bmax]
    payload = bytes(data[block.start:block.start + block.size])
    if not block.compressed:
        return payload == want
    prefix = content[max(0, block.out_pos - (64 << 10)):block.out_pos] if block.linked else b""
    try:
        return zlz4.decode_block(payload, prefix) == want
    except DecompressError:
        return False


def _zstd_frame_ok(data: bytes, fr, content: bytes) -> bool:
    start, end, pos, size = fr
    try:
        got = zframe.decompress(bytes(data[start:end]))
    except (DecompressError, IndexError, ValueError):
        return False
    return got == content[pos:pos + size]


def check_archives(archives, order, contents, hashes, method, rng, samples):
    """Counts of the records, hashes, frames and sampled blocks that are
    wrong over ``archives``, each of which should hold the entries ``order``
    with ``contents`` by ``method`` (1 zstd, 2 LZ4).  ``samples`` blocks (or
    zstd frames) are decoded, spread over the archives."""
    wrong = {"records_wrong": 0, "hashes_wrong": 0, "frames_wrong": 0, "blocks_wrong": 0}
    per = max(1, -(-samples // max(1, len(archives))))
    checked = 0
    for buf in archives:
        entries, faults = zarc.parse(buf)
        view = memoryview(buf)
        if (faults or [e.name for e in entries] != list(order)
                or any(e.method != method or e.uncomp_size != len(contents[e.name])
                       for e in entries)):
            wrong["records_wrong"] += 1
            continue
        wrong["hashes_wrong"] += sum(e.hash != hashes[e.name] for e in entries)
        units = []
        for e in entries:
            data = view[e.offset:e.offset + e.comp_size]
            if method == 2:
                found, ok = _lz4_units(data, e.uncomp_size)
                units += [(e, b, bmax) for b, bmax in found]
            else:
                try:
                    frs = zstd_frames(data)
                    ok = (frs[-1][2] is None or frs[-1][3] is None
                          or frs[-1][2] + frs[-1][3] == e.uncomp_size)
                except (DecompressError, IndexError, struct.error):
                    frs, ok = [], False
                units += [(e, f, None) for f in frs if f[2] is not None and f[3] is not None]
            wrong["frames_wrong"] += not ok
        if not units:
            continue
        for k in rng.choice(len(units), size=min(per, len(units)), replace=False):
            e, unit, bmax = units[int(k)]
            data = view[e.offset:e.offset + e.comp_size]
            content = contents[e.name]
            ok = (_lz4_block_ok(data, unit, content, bmax) if method == 2
                  else _zstd_frame_ok(data, unit, content))
            wrong["blocks_wrong"] += not ok
            checked += 1
    return wrong, checked


def check_reads(sampled, sizes, contents):
    """``reads_wrong`` over the sampled ``(name, bytes)`` reads and
    ``read_sizes_wrong`` over every ``(name, length)``."""
    return {
        "reads_wrong": sum(out != contents[name] for name, out in sampled),
        "read_sizes_wrong": sum(n != len(contents[name]) for name, n in sizes),
    }


def compared(counts: dict) -> dict:
    """The numbers compared with their limits, from the counts."""
    return {k: sum(counts[p] for p in PARTS[k]) for k in LIMITS}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def sample_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), 7])
