"""The port's multi-process compression (``parallel/distributed.py`` on
``torch.distributed``) on two gloo CPU ranks against the JAX package.

Two real processes join one gloo group over ``tcp://127.0.0.1:<free
port>`` and run ``compress_multihost`` (200,000 bytes at 32 KiB blocks),
``compress_multihost_zstd`` and ``build_archive_multihost`` (the 12 JSONL
files of ``tests/test_distributed.py``) on the CPU.  Both ranks must return
the same bytes, and those bytes must equal what the JAX functions return in
this test's own process (one JAX process: none of the three outputs depends
on the process count, since every rank assembles the whole result from the
same per-block, per-chunk and per-entry bytes).  Also: ``shard_ranges`` on a
grid against JAX's, the ragged all-gather with empty payloads, and the
functions without a process group (rank 0 of 1)."""

import hashlib
import json
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from zpack_tpu.parallel import distributed as jax_distributed
from zpack_tpu.parallel.pipeline import MeshCompressor
from zpack_tpu_torch import engine
from zpack_tpu_torch.codecs.lz4 import frame as lz4frame
from zpack_tpu_torch.parallel import distributed

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

INPUTS = textwrap.dedent(
    """
    import numpy as np

    def lz4_data():
        rng = np.random.default_rng(1)
        return bytes(np.where(rng.random(200000) < 0.8,
                              np.tile(np.frombuffer(b"distributed!", dtype=np.uint8), 16667)[:200000],
                              rng.integers(0, 256, 200000)).astype(np.uint8))

    def jsonl_files():
        rng = np.random.default_rng(5)
        files = []
        for i in range(12):
            rows = b"".join(
                b'{"user":"u%04d","score":%05d,"tag":"%s"}\\n'
                % (int(rng.integers(5000)), int(rng.integers(90000)),
                   [b"alpha", b"beta", b"gamma"][int(rng.integers(3))])
                for _ in range(400))
            files.append((f"logs/part{i:02d}.jsonl", rows))
        return files
    """
)

WORKER = INPUTS + textwrap.dedent(
    """
    import hashlib, json, sys
    import torch
    torch.set_num_threads(1)
    rank, world, port, dest = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from zpack_tpu_torch import engine
    from zpack_tpu_torch.parallel import distributed as D
    D.initialize(f"127.0.0.1:{port}", world, rank)
    D.initialize(f"127.0.0.1:{port}", world, rank)  # a second call does nothing
    engine.install("cpu")
    data = lz4_data()
    out = {
        "rank_world": D._rank_world(),
        "lz4": D.compress_multihost(data, 1, block_size=32 << 10, device="cpu").hex(),
        "zstd": D.compress_multihost_zstd(data[:150000], 3, chunk_size=40000).hex(),
        "archive": D.build_archive_multihost(jsonl_files(), level=3).hex(),
        "empty": [p.hex() for p in D._allgather_ragged(b"")],
        "ragged": [p.hex() for p in D._allgather_ragged(b"x" * rank)],
    }
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(dest, "w") as f:
        json.dump(out, f)
    """
)

exec(INPUTS)  # lz4_data, jsonl_files


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    port = _free_port()
    dest = tmp_path_factory.mktemp("ranks")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), "2", str(port),
                               str(dest / f"rank{rank}.json")],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank in (1, 0)]
    outs = {}
    try:
        for rank, p in zip((1, 0), procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, out[-2000:] + err[-3000:]
            outs[rank] = json.loads((dest / f"rank{rank}.json").read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture
def small_jax_steps(monkeypatch):
    """The JAX compressor with steps of one block a device (its frames do
    not depend on the step; the default pads each block to 8 MiB)."""
    monkeypatch.setattr(MeshCompressor, "BYTES_PER_DEVICE_STEP", 32 << 10)


def test_ranks_know_their_place(two_ranks):
    assert two_ranks[0]["rank_world"] == [0, 2] and two_ranks[1]["rank_world"] == [1, 2]


@pytest.mark.parametrize("key", ["lz4", "zstd", "archive"])
def test_both_ranks_return_the_same_bytes(two_ranks, key):
    assert two_ranks[0][key] == two_ranks[1][key]


def test_two_rank_lz4_frame_equals_jax(two_ranks, small_jax_steps):
    data = lz4_data()
    want = jax_distributed.compress_multihost(data, 1, block_size=32 << 10)
    got = bytes.fromhex(two_ranks[0]["lz4"])
    assert got == want
    assert lz4frame.decompress_frame(got) == data


def test_two_rank_zstd_frames_equal_jax(two_ranks):
    from zpack_tpu_torch import native

    data = lz4_data()[:150000]
    want = jax_distributed.compress_multihost_zstd(data, 3, chunk_size=40000)
    got = bytes.fromhex(two_ranks[0]["zstd"])
    assert got == want
    assert native.zstd_decompress(got, len(data)) == data


def test_two_rank_archive_equals_jax(two_ranks):
    from zpack_tpu_torch.reader import Reader

    files = jsonl_files()
    want = jax_distributed.build_archive_multihost(files, level=3)
    got = bytes.fromhex(two_ranks[0]["archive"])
    assert got == want
    engine.install("cpu")
    try:
        r = Reader.from_memory(got, shared=True)
        assert "__zpack.dict" in [e.filename for e in r.file_entries]
        for name, data in files:
            assert r.read_file(name) == data
    finally:
        engine.uninstall()


def test_ragged_allgather_with_empty_payloads(two_ranks):
    for rank in (0, 1):
        assert two_ranks[rank]["empty"] == ["", ""]
        assert two_ranks[rank]["ragged"] == ["", "78"]


@pytest.mark.parametrize("n", [0, 1, 2, 5, 7, 12, 100])
@pytest.mark.parametrize("procs", [1, 2, 3, 4, 8])
def test_shard_ranges_match_jax(n, procs):
    got = distributed.shard_ranges(n, procs)
    assert got == jax_distributed.shard_ranges(n, procs)
    assert [b for r in got for b in range(*r)] == list(range(n))


def test_without_a_group_every_function_is_rank_0_of_1(small_jax_steps):
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert distributed._rank_world() == (0, 1)
    assert distributed._allgather_ragged(b"abc") == [b"abc"]
    data = lz4_data()[:100000]
    for B in (32 << 10, 4096):
        assert distributed.compress_multihost(data, 1, block_size=B, device="cpu") == \
            jax_distributed.compress_multihost(data, 1, block_size=B)
    assert distributed.compress_multihost(b"", device="cpu") == \
        jax_distributed.compress_multihost(b"")
    assert distributed.compress_multihost_zstd(data, 3, chunk_size=30000) == \
        jax_distributed.compress_multihost_zstd(data, 3, chunk_size=30000)
    assert hashlib.sha256(distributed.build_archive_multihost(jsonl_files()[:3])).digest() == \
        hashlib.sha256(jax_distributed.build_archive_multihost(jsonl_files()[:3])).digest()
