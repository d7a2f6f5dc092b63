"""The port's mesh-parallel archive builder (``parallel/archive.py``)
against the JAX package's on the CPU: the archive bytes of
``write_archive_parallel`` equal the JAX function's on the 8-device CPU
mesh, for meshes of 1, 2, 3 and 8 CPU "devices" and blocks of 4 and 64 KiB
(the files of ``tests/test_parallel_archive.py``, the empty entry included,
and an entry on which the native and the python LZ4 serializers differ),
and the archive reads back through the port's Reader, also through
``extract_iter(chunk_size=777)``."""

import functools

import numpy as np
import pytest
import torch

from test_parallel_archive import _mix
from zpack_tpu.parallel.archive import write_archive_parallel as jax_write_archive_parallel
from zpack_tpu.parallel.pipeline import make_mesh as jax_make_mesh
from zpack_tpu.writer import Writer as JaxWriter
from zpack_tpu_torch import engine
from zpack_tpu_torch.parallel import archive
from zpack_tpu_torch.parallel.pipeline import make_mesh
from zpack_tpu_torch.reader import Reader
from zpack_tpu_torch.writer import Writer

torch.set_num_threads(1)


def _records(n: int) -> bytes:
    """80% a repeated 12-byte record, 20% noise: blocks on which the native
    LZ4 serializer and the JAX function's python serializer write different
    bytes, so the archive must take the python one."""
    rng = np.random.default_rng(1)
    rec = np.tile(np.frombuffer(b"distributed!", dtype=np.uint8), n // 12 + 1)[:n]
    return np.where(rng.random(n) < 0.8, rec, rng.integers(0, 256, n)).astype(np.uint8).tobytes()


FILES = [
    ("small.txt", _mix(500, 1)),
    ("medium.bin", _mix(20000, 2)),
    ("large.dat", _mix(150000, 3)),
    ("empty.txt", b""),
    ("records.bin", _records(100000)),
]


def _archive(writer_cls, write, mesh, B: int) -> bytes:
    w = writer_cls.to_heap()
    w.write_header()
    w.write_data_header()
    write(w, FILES, mesh, block_size=B)
    w.write_cdr()
    w.write_eocdr()
    return w.buffer


@functools.lru_cache(maxsize=None)
def _jax_archive(B: int) -> bytes:
    return _archive(JaxWriter, jax_write_archive_parallel, jax_make_mesh(), B)


@pytest.fixture
def cpu_engine():
    engine.install("cpu")
    yield
    engine.uninstall()


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("B", [4096, 65536])
def test_archive_bytes_match_jax(B, k, cpu_engine):
    got = _archive(Writer, archive.write_archive_parallel, make_mesh(["cpu"] * k), B)
    assert got == _jax_archive(B)
    r = Reader.from_memory(got)
    assert r.file_count == len(FILES)
    for name, data in FILES:
        assert r.read_file(name) == data  # XXH3 verified
        entry = r.get_file_entry(name)
        assert b"".join(r.extract_iter(entry, chunk_size=777)) == data


def test_entries_keep_their_order_sizes_and_hashes():
    from zpack_tpu_torch.codecs.xxh3 import xxh3_64

    out = archive.compress_entries_parallel(FILES, make_mesh(["cpu"] * 3), block_size=4096)
    assert [(n, u, h) for n, _, u, h in out] == [(n, len(d), xxh3_64(d)) for n, d in FILES]
    # the empty entry is a frame header and the end mark alone
    assert len(out[3][1]) == 7 + 4


def test_the_native_serializer_differs_on_the_records_entry():
    """Why ``serialize_blocks`` keeps the python serializer: on the records
    entry at 64 KiB blocks, ``DeviceCompressor.compress`` (native) writes
    other bytes."""
    from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

    dc = DeviceCompressor("cpu", block_size=65536)
    frame = archive._assemble_entry(dc, FILES[4][1], 64 << 10)
    native_frame = dc.compress(FILES[4][1])
    assert frame != native_frame


def test_a_device_stands_for_a_mesh_of_one():
    assert archive.compress_entries_parallel(FILES[:2], "cpu", block_size=4096) == \
        archive.compress_entries_parallel(FILES[:2], make_mesh(["cpu"]), block_size=4096)
