"""Mesh-parallel archive building: many entries, many blocks.

Counterpart of ``zpack_tpu/parallel/archive.py``: every entry is split into
independent lz4f blocks, the blocks are tokenized on the device mesh
(:class:`DeviceCompressor`, its shards one a mesh device), and the host
serializes each block and appends the entries in input order (XXH3 by the
native host backend).  The archives are byte-identical to the JAX
function's.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import constants as C
from ..codecs.lz4 import frame as lz4frame
from ..codecs.xxh3 import xxh3_64
from ..format import records
from ..kernels import lz4_torch
from .pipeline import BLOCK, DeviceCompressor, make_mesh


def compress_entries_parallel(
    files: list[tuple[str, bytes]],
    mesh=None,
    level: int = 1,
    block_size: int = BLOCK,
) -> list[tuple[str, bytes, int, int]]:
    """Compress many (name, data) entries block-parallel on ``mesh`` (a
    ``DeviceMesh`` or a device; default: every visible CUDA device).

    Returns [(name, lz4f_frame_bytes, uncomp_size, xxh3_hash)], frames
    assembled per entry in order."""
    dc = DeviceCompressor(mesh if mesh is not None else make_mesh(), level=level,
                          block_size=block_size)
    # B <= 64 KiB, so the declared frame block size is the smallest, 64 KiB
    declared = 64 << 10
    return [(name, _assemble_entry(dc, data, declared), len(data), xxh3_64(data))
            for name, data in files]


def _assemble_entry(dc: DeviceCompressor, data: bytes, declared: int) -> bytes:
    """One entry's lz4f frame: the header, :func:`serialize_blocks` of the
    entry, the end mark."""
    out = bytearray(lz4frame._header(declared, True, False, None))
    if data:
        out += serialize_blocks(dc, data)
    out += struct.pack("<I", 0)
    return bytes(out)


def serialize_blocks(dc: DeviceCompressor, data: bytes) -> bytes:
    """The lz4f blocks of ``data`` (each its size word and its bytes, stored
    where compressing does not shrink it): the device tokenizes, and the
    python serializer of the JAX function (``lz4_torch.serialize_block_host``)
    writes each block.  The native serializer that ``dc.compress`` uses
    makes other bytes on some inputs, though both decode alike."""
    B = dc.block_size
    src, mlen, nb, _ = dc.tokenize(data)
    out = bytearray()
    posa = np.arange(B)
    for i in range(nb):
        chunk = data[i * B : (i + 1) * B]
        ml = mlen[i]
        if len(chunk) != B:
            # tail block: clamp the device results to the real length
            ml = np.minimum(ml, np.maximum(len(chunk) - 5 - posa, 0))
            ml = np.where(posa >= max(len(chunk) - 12, 0), 0, ml)
            ml = np.where(ml < 4, 0, ml)
        comp = lz4_torch.serialize_block_host(chunk, src[i], ml, lz4_torch.CAPJ)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000) + chunk
    return bytes(out)


def write_archive_parallel(writer, files, mesh=None, level: int = 1,
                           block_size: int = BLOCK) -> None:
    """Build a full archive with mesh-parallel LZ4 compression.

    ``writer`` is a ``zpack_tpu_torch.writer.Writer`` already positioned
    past the data header; entries are appended pre-compressed in input
    order (the ordered ragged gather), then the caller writes CDR/EOCDR.
    """
    results = compress_entries_parallel(list(files), mesh, level, block_size)
    for name, frame_bytes, uncomp, h in results:
        offset = writer.write_offset
        writer._emit(frame_bytes)
        writer.file_entries.append(
            records.FileEntry(
                filename=name,
                offset=offset,
                comp_size=len(frame_bytes),
                uncomp_size=uncomp,
                hash=h,
                comp_method=int(C.CompressionMethod.LZ4),
            )
        )
