"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA GPU and skips without one.  This file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from zpack_tpu.codecs import xxh3 as H
from zpack_tpu.codecs.lz4 import block as lz4block
from zpack_tpu.constants import CompressionMethod
from zpack_tpu.reader import Reader
from zpack_tpu.writer import CompressOptions, Writer
from zpack_tpu_torch import engine
from zpack_tpu_torch.kernels import lz4_torch, xxh3_torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    return b"".join(words[i] for i in rng.integers(0, len(words), n // 4))[:n]


def _rows(B: int) -> list[bytes]:
    noise = np.random.default_rng(B).integers(0, 256, B, dtype=np.uint8).tobytes()
    tail = _text(B // 2 + 77, 3)
    return [_text(B, 1), noise, bytes(B), (b"xy" * B)[:B], tail + bytes(B - len(tail))]


@pytest.mark.parametrize("capj", [8, 16])
@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("B", [4096, 65536])
def test_tokenize_kernel_matches_plain(cuda, B, depth, capj):
    blocks = torch.from_numpy(
        np.frombuffer(b"".join(_rows(B)), np.uint8).reshape(-1, B).copy()).to(cuda)
    got = lz4_torch.tokenize(blocks, depth, capj)
    want = lz4_torch.tokenize_plain(blocks, depth, capj)
    torch.cuda.synchronize()
    assert torch.equal(got[0].to(torch.int32), want[0].to(torch.int32))
    assert torch.equal(got[1], want[1])


def test_replay_kernel_matches_plain(cuda):
    raws = [_text(65536, 5), b"a" * 5000 + b"bc" * 2000, b"x" * 65536, _text(1000, 6),
            np.random.default_rng(7).integers(0, 256, 3000, dtype=np.uint8).tobytes()]
    batch = lz4_torch.build_batch([lz4block.compress_block(r) for r in raws],
                                  [len(r) for r in raws])
    args = [torch.from_numpy(batch[k]).to(cuda) for k in lz4_torch.REPLAY_ARGS]
    got = lz4_torch.replay(*args, n_out=batch["n_out"])
    want = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = got.cpu().numpy()
    assert [out[i, : len(r)].tobytes() for i, r in enumerate(raws)] == raws


def test_engine_round_trip_launches_both_kernels(cuda, monkeypatch):
    monkeypatch.delenv("ZPACK_TPU_ENGINE", raising=False)
    data = _text(1 << 20, 8) + bytes(70000)
    engine.install(cuda)
    try:
        lz4_torch.reset_launches()
        w = Writer.to_heap()
        w.write_archive([("d.bin", data, CompressOptions(CompressionMethod.LZ4, 1))])
        assert Reader.from_memory(w.buffer, shared=True).read_file("d.bin") == data
    finally:
        engine.uninstall()
    assert lz4_torch.LAUNCHES["lz4_tokenize"] > 0 and lz4_torch.LAUNCHES["lz4_replay"] > 0


_XXH3_EDGES = [241, 255, 256, 257, 1024, 1025, 1088, 1089, 16384, 16385, 65536, 200001]


def _xxh3_streams(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


@pytest.mark.parametrize("lengths", [
    _XXH3_EDGES,
    list(np.random.default_rng(20).integers(241, 70000, 1000)) + [0, 16, 240],
], ids=["edges", "ragged-1000"])
def test_xxh3_batch_kernel_matches_plain(cuda, lengths):
    streams = _xxh3_streams(lengths, 21)
    long = [s for s in streams if len(s) > H.MIDSIZE_MAX]
    flat, offsets = xxh3_torch.split_packed(xxh3_torch.pack(long).to(cuda), len(long))
    acc, hashes = xxh3_torch.accumulate_batch(flat, offsets, xxh3_torch.secret_tensor(cuda))
    want_acc, want_hashes = xxh3_torch.hash_batch_plain(flat, offsets)
    torch.cuda.synchronize()
    assert torch.equal(acc, want_acc) and torch.equal(hashes, want_hashes)
    assert xxh3_torch.xxh3_64_batch(streams, cuda) == [H.xxh3_64(s) for s in streams]


def test_xxh3_batch_kernel_rows_in_place(cuda):
    raw = _xxh3_streams([50000], 22)[0]
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(cuda)
    rows = [[8, 1000], [16, 4000], [5000, 300], [96, 44000], [0, 50000], [49752, 241]]
    offsets = torch.tensor(rows, dtype=torch.int64, device=cuda)
    acc, hashes = xxh3_torch.accumulate_batch(flat, offsets, xxh3_torch.secret_tensor(cuda))
    want_acc, want_hashes = xxh3_torch.hash_batch_plain(flat, offsets)
    torch.cuda.synchronize()
    assert torch.equal(acc, want_acc) and torch.equal(hashes, want_hashes)
    assert hashes.cpu().numpy().view(np.uint64).tolist() == [
        H.xxh3_64(raw[s:s + n]) for s, n in rows]


def test_xxh3_batch_kernel_rejected_rows_yield_zeros(cuda):
    """Rows the plain version rejects (unaligned, short, outside flat) read
    nothing on the card; the valid row beside them is still hashed."""
    raw = _xxh3_streams([5000], 25)[0]
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(cuda)
    rows = [[4, 1000], [0, 240], [4096, 1000], [-8, 1000], [0, 5000]]
    offsets = torch.tensor(rows, dtype=torch.int64, device=cuda)
    acc, hashes = xxh3_torch.accumulate_batch(flat, offsets, xxh3_torch.secret_tensor(cuda))
    torch.cuda.synchronize()
    assert not acc[:4].any() and not hashes[:4].any()
    assert hashes[4:].cpu().numpy().view(np.uint64).tolist() == [H.xxh3_64(raw)]


@pytest.mark.parametrize("n", _XXH3_EDGES + [(4 << 20) + 7])
def test_xxh3_stream_kernel_matches_plain(cuda, n):
    raw = _xxh3_streams([n], n)[0]
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(cuda)
    acc, hashes = xxh3_torch.accumulate_stream(data, xxh3_torch.secret_tensor(cuda))
    want_acc, want_hashes = xxh3_torch.hash_stream_plain(data)
    torch.cuda.synchronize()
    assert torch.equal(acc, want_acc) and torch.equal(hashes, want_hashes)
    assert xxh3_torch.xxh3_64(raw, cuda) == H.xxh3_64(raw)


def test_xxh3_entry_points_launch_kernels(cuda):
    xxh3_torch.reset_launches()
    xxh3_torch.xxh3_64_batch(_xxh3_streams([300, 5000], 23), cuda)
    xxh3_torch.xxh3_64(_xxh3_streams([5000], 24)[0], cuda)
    assert xxh3_torch.LAUNCHES == {"xxh3_batch": 1, "xxh3_stream": 1}
