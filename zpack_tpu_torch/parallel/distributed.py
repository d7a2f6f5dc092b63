"""Multi-process distributed compression over ``torch.distributed``.

Counterpart of ``zpack_tpu/parallel/distributed.py`` (``jax.distributed``).
Every process (rank) takes a contiguous range of the blocks, chunks or
entries, compresses it on its own device, and the ragged results are
all-gathered, so that every rank assembles the same frame or archive in
order.  The gathers carry host bytes over the gloo backend, as
``multihost_utils.process_allgather`` does; gloo also lets two ranks share
one card, which NCCL refuses.  Without a process group every function runs
as rank 0 of 1.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the gloo process group at ``coordinator_address`` ("host:port")
    as rank ``process_id`` of ``num_processes``, or by ``env://`` when the
    address is None.  Does nothing when the group already exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group("gloo", init_method=init, **kwargs)


def _rank_world() -> tuple[int, int]:
    """This process's rank and the world size; 0 and 1 with no group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_ranges(n_blocks: int, num_processes: int) -> list[tuple[int, int]]:
    """Contiguous block ranges per process (rank h owns range h)."""
    per = -(-n_blocks // num_processes)
    return [(min(h * per, n_blocks), min((h + 1) * per, n_blocks))
            for h in range(num_processes)]


def _allgather_ragged(local: bytes) -> list[bytes]:
    """All-gather one variable-length byte payload a rank: the lengths as
    int64, then the payloads padded to the longest as uint8."""
    import torch.distributed as dist

    _rank, world = _rank_world()
    if world == 1:
        return [bytes(local)]
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([len(local)], dtype=torch.int64))
    lens = [int(t) for t in lens]
    padded = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    padded[: len(local)] = torch.from_numpy(np.frombuffer(local, dtype=np.uint8).copy())
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return [g[:k].numpy().tobytes() for g, k in zip(gathered, lens)]


def compress_multihost_zstd(data: bytes, level: int = 19,
                            chunk_size: int = 8 << 20) -> bytes:
    """zstd chunks sharded data-parallel across ranks: each rank compresses
    its contiguous chunk range into separate zstd frames (native backend),
    the ragged frames all-gather, and every rank assembles the identical
    concatenated multi-frame stream in chunk order."""
    from .. import native

    rank, world = _rank_world()
    data = bytes(data)
    n_chunks = max(1, -(-len(data) // chunk_size))
    lo, hi = shard_ranges(n_chunks, world)[rank]
    local = b"".join(
        native.zstd_compress(data[i * chunk_size : (i + 1) * chunk_size], level) or b""
        for i in range(lo, hi)
    )
    return b"".join(_allgather_ragged(local))


def compress_multihost(data: bytes, level: int = 1, block_size: int = 64 << 10,
                       *, device="cuda") -> bytes:
    """Compress ``data`` with each rank tokenizing and serializing its
    contiguous block range on ``device`` (a device or a ``DeviceMesh``),
    then all-gather the ragged compressed blocks and assemble the lz4f frame
    in block order.

    Every rank must call this with identical ``data``; returns the frame on
    every rank."""
    from ..codecs.lz4 import frame as lz4frame
    from .archive import serialize_blocks
    from .pipeline import DeviceCompressor

    rank, world = _rank_world()
    data = bytes(data)
    B = block_size
    n_blocks = max(1, -(-len(data) // B))
    lo, hi = shard_ranges(n_blocks, world)[rank]
    body = b""
    if lo < hi:
        body = serialize_blocks(DeviceCompressor(device, level=level, block_size=B),
                                data[lo * B : hi * B])
    return (lz4frame._header(max(B, 64 << 10), True, False, None)
            + b"".join(_allgather_ragged(body)) + struct.pack("<I", 0))


def build_archive_multihost(files: list[tuple[str, bytes]], level: int = 3,
                            dict_size: int = 4096) -> bytes:
    """Build one multi-entry .zpk archive across ranks:

    1. rank 0 trains a shared zstd dictionary on entry samples and sends it
       to every rank (a ragged all-gather),
    2. each rank compresses its contiguous entry range against the
       dictionary into a local archive (the codecs as ``engine.install``
       set them),
    3. the local archives all-gather, and every rank assembles the same
       final archive in entry order with the archive-to-archive raw copy,
       so compressed bytes move exactly once.

    Every rank must pass identical ``files``; returns the archive bytes on
    every rank."""
    from .. import constants as C
    from ..codecs.zstd.dict import train_dictionary
    from ..constants import CompressionMethod
    from ..reader import Reader
    from ..writer import CompressOptions, Writer

    rank, world = _rank_world()

    # 1. train on rank 0, send to all
    if rank == 0:
        samples = []
        for _, data in files:
            for i in range(0, min(len(data), 1 << 16), 1024):
                samples.append(data[i : i + 1024])
        blob = train_dictionary(samples, dict_size)
    else:
        blob = b""
    blob = _allgather_ragged(blob)[0]

    # 2. compress the local entry range into a local archive
    lo, hi = shard_ranges(len(files), world)[rank]
    lw = Writer.to_heap()
    lw.write_header()
    lw.write_data_header()
    lw.set_dictionary(blob)
    for name, data in files[lo:hi]:
        lw.add_file(name, data, CompressOptions(CompressionMethod.ZSTD, level))
    lw.write_cdr()
    lw.write_eocdr()

    # 3. all-gather the local archives; assemble identically on every rank
    locals_ = _allgather_ragged(lw.buffer)
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    w.set_dictionary(blob)
    w._ensure_dict_entry()
    for h in range(world):
        r = Reader.from_memory(locals_[h], shared=True)
        entries = [e for e in r.file_entries
                   if e.filename != C.DICT_ENTRY_NAME]
        w.write_files_from_archive(r, entries)
    w.write_cdr()
    w.write_eocdr()
    return w.buffer
