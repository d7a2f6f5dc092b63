"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA GPU and skips without one.  This file imports
no jax and nothing of the JAX package, so it also runs where jax is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from zpack_tpu_torch import engine, native
from zpack_tpu_torch.codecs import xxh3 as H
from zpack_tpu_torch.codecs.lz4 import block as lz4block, frame as lz4frame
from zpack_tpu_torch.codecs.zstd import encode as zenc, frame as zframe, huffman as zhuf, seq as zseq
from zpack_tpu_torch.codecs.zstd import fse as zfse
from zpack_tpu_torch.codecs.zstd.dict import train_dictionary
from zpack_tpu_torch.constants import CompressionMethod
from zpack_tpu_torch.reader import Reader
from zpack_tpu_torch.writer import CompressOptions, Writer
from zpack_tpu_torch.codecs import zstd as port_zstd
from rep_cases import REP_EDGE_LENGTHS, rep_edge_case
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import (assemble_cases, assemble_torch, fse_cases, fse_encode_cases,
                                     fse_torch, huffman_cases, huffman_encode_cases, huffman_torch,
                                     lz4_parse_cases, lz4_torch, replay_cases, serialize_cases,
                                     tokenize_cases, xxh3_cases, xxh3_torch, zstd_chain)
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor
from zpack_tpu_torch.utils.observe import launches, metrics

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


@pytest.mark.parametrize("capj", [5, 8, 13, 16])
@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("B", [4096, 65536])
def test_tokenize_kernel_matches_plain(cuda, B, depth, capj):
    """Both CTA shapes (windows up to 16 KiB, and larger), text, noise and
    zero rows beside every adversarial case cut to the width; caps that are
    and are not whole 4-byte words (the kernel compares a word at a time)."""
    rows = np.frombuffer(b"".join(_rows(B)), np.uint8).reshape(-1, B)
    blocks = torch.from_numpy(np.concatenate([rows, tokenize_cases.mixed_batch(B)])).to(cuda)
    got = lz4_torch.tokenize(blocks, depth, capj)
    want = lz4_torch.tokenize_plain(blocks, depth, capj)
    torch.cuda.synchronize()
    assert torch.equal(got[0].to(torch.int32), want[0].to(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("capj", [20, 32])
@pytest.mark.parametrize("depth", [32, 64])
@pytest.mark.parametrize("B", [4096, 65536])
def test_tokenize_kernel_matches_plain_at_hc_settings(cuda, B, depth, capj):
    """The HC levels' deep chains and comparisons past 16 bytes (up to the
    32 the zero pad past a window allows), in both CTA shapes."""
    rows = np.frombuffer(b"".join(_rows(B)), np.uint8).reshape(-1, B)
    blocks = torch.from_numpy(np.concatenate([rows, tokenize_cases.mixed_batch(B)])).to(cuda)
    got = lz4_torch.tokenize(blocks, depth, capj)
    want = lz4_torch.tokenize_plain(blocks, depth, capj)
    torch.cuda.synchronize()
    assert torch.equal(got[0].to(torch.int32), want[0].to(torch.int32))
    assert torch.equal(got[1], want[1])


def _windows(B: int, dict_pad: int, cuda) -> torch.Tensor:
    """Text, noise and zero rows and every adversarial case cut to ``B``
    bytes, each behind the same ``dict_pad`` bytes of dictionary."""
    rows = np.concatenate([np.frombuffer(b"".join(_rows(B)), np.uint8).reshape(-1, B),
                           tokenize_cases.mixed_batch(B)])
    head = np.frombuffer(_text(dict_pad, 9), np.uint8)
    return torch.from_numpy(
        np.concatenate([np.broadcast_to(head, (len(rows), dict_pad)), rows], axis=1).copy()).to(cuda)


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("mode,capj,B,dict_pad", [
    ("u16", 8, 8192, 0), ("u16", 8, 4096, 2048), ("u16", 8, 1000, 24),
    ("pair", 8, 8192, 2048), ("pair", 8, 63488, 2048),
    ("hash", 8, 65536, 0), ("hash", 16, 65536, 0), ("hash", 8, 16384, 0), ("hash", 16, 384, 0),
    ("scatter", 16, 65536, 0), ("scatter", 16, 16384, 0), ("scatter", 16, 8192, 2048),
])
def test_tokenize_epilogues_and_est_match_plain(cuda, mode, capj, B, dict_pad, depth):
    blocks = _windows(B, dict_pad, cuda)
    mark = launches()
    got, est = lz4_torch.tokenize_est(blocks, depth, capj, mode, dict_pad)
    want = lz4_torch.tokenize_plain(blocks, depth, capj, mode, dict_pad)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.to(torch.int32), w.to(torch.int32))
    assert torch.equal(est, lz4_torch.est_plain(want, mode))
    assert launches(mark) == {lz4_torch.launch_key(mode): 1}


_TOKENIZE_CASES = tokenize_cases.cases()


@pytest.mark.parametrize("name", sorted(_TOKENIZE_CASES))
def test_tokenize_kernel_matches_plain_on_adversarial_windows(cuda, name):
    """One bucket as long as the window, buckets across every warp's stretch,
    windows that are no power of two, dictionary windows, the end rules and
    chains longer than the depth: exact in every mode the window admits."""
    case = _TOKENIZE_CASES[name]
    blocks = torch.from_numpy(np.stack([case.window, case.window[::-1].copy()])).to(cuda)
    for mode, capj in tokenize_cases.admitted(case):
        for depth in case.depths:
            got, est = lz4_torch.tokenize_est(blocks, depth, capj, mode, case.dict_pad)
            want = lz4_torch.tokenize_plain(blocks, depth, capj, mode, case.dict_pad)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(g.to(torch.int32), w.to(torch.int32)), (mode, capj, depth)
            assert torch.equal(est, lz4_torch.est_plain(want, mode)), (mode, capj, depth)


def test_tokenize_large_window_needs_no_power_of_two_scratch(cuda):
    """A window over the small shape's limit takes two bytes of scratch a
    position and no more; a small one, and "hash", none at all."""
    for W, mode, scratch in ((40000, "pair", 2 * 40000), (16384, "pair", 0), (40000, "hash", 0)):
        blocks = torch.from_numpy(tokenize_cases.mixed_batch(W)[:4]).to(cuda)
        out_bytes = sum(4 * W * t.itemsize for t in lz4_torch.WIRE_DTYPES[mode])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = lz4_torch.tokenize(blocks, 2, 8, mode)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        assert peak <= out_bytes + 4 * scratch + 4096, (W, mode, peak)
        want = lz4_torch.tokenize_plain(blocks, 2, 8, mode)
        assert all(torch.equal(g.to(torch.int32), w.to(torch.int32)) for g, w in zip(got, want))


def test_tokenize_refuses_what_the_wire_cannot_hold(cuda):
    blocks = _windows(8192, 2048, cuda)
    with pytest.raises(ValueError, match="13 bits"):
        lz4_torch.tokenize(blocks, 2, 8, "u16", 2048)
    with pytest.raises(ValueError, match="3 bits"):
        lz4_torch.tokenize(blocks[:, :8192].contiguous(), 2, 16, "u16")
    with pytest.raises(ValueError, match="no dictionary"):
        lz4_torch.tokenize(blocks, 2, 8, "hash", 2048)


@pytest.mark.parametrize("B", [4096, 8192])
def test_compress_zstd_with_dictionary_on_cuda(cuda, B):
    data = _text(300000, 50) + np.random.default_rng(51).integers(
        0, 256, 40000, dtype=np.uint8).tobytes() + _text(4321, 52)
    blob = train_dictionary([data[i:i + 512] for i in range(0, 8192, 512)], 2048)
    mark = launches()
    got = DeviceCompressor(cuda, block_size=B).compress_zstd(data, 3, dictionary=blob)
    key = "lz4_tokenize_u16" if B == 4096 else "lz4_tokenize"
    other = "lz4_tokenize" if B == 4096 else "lz4_tokenize_u16"
    run = launches(mark)
    assert run[key] > 0 and run[other] == 0
    assert got == DeviceCompressor("cpu", block_size=B).compress_zstd(data, 3, dictionary=blob)
    assert zframe.decompress(got, dictionary=blob) == data


def test_lz4_compress_u16_mode_on_cuda(cuda):
    data = _text(500000, 53) + bytes(30001)
    mark = launches()
    dc = DeviceCompressor(cuda, block_size=8192)
    got = dc.compress(data)
    run = launches(mark)
    assert run["lz4_tokenize_u16"] > 0 and run["lz4_tokenize"] == 0
    assert got == DeviceCompressor("cpu", block_size=8192).compress(data)
    assert lz4frame.decompress_frame(got, len(data)) == data
    cpu, gpu = DeviceCompressor("cpu", block_size=8192).tokenize(data), dc.tokenize(data)
    assert cpu[2:] == gpu[2:] and all(np.array_equal(a, b) for a, b in zip(cpu[:2], gpu[:2]))


def test_entry_and_compress_block_on_cuda(cuda):
    forward, (sample,) = lz4_torch.entry(cuda)
    cpu_forward, (cpu_sample,) = lz4_torch.entry("cpu")
    mark = launches()
    got, want = forward(sample), cpu_forward(cpu_sample)
    assert launches(mark)["lz4_tokenize_scatter"] == 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    for n in (5, 300, 16384, 20001):
        raw = _text(n, n)
        comp = lz4_torch.compress_block(raw, cuda)
        assert comp == lz4_torch.compress_block(raw, "cpu")
        assert lz4block.decompress_block(comp, len(raw)) == raw
    assert launches(mark)["lz4_tokenize_hash"] == 3


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


def test_engine_round_trip_launches_both_kernels(cuda):
    data = _text(1 << 20, 8) + bytes(70000)
    engine.install(cuda)
    try:
        mark = launches()
        w = Writer.to_heap()
        w.write_archive([("d.bin", data, CompressOptions(CompressionMethod.LZ4, 1))])
        assert Reader.from_memory(w.buffer, shared=True).read_file("d.bin") == data
    finally:
        engine.uninstall()
    run = launches(mark)
    assert run["lz4_tokenize"] > 0 and run["lz4_replay"] > 0


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
    mark = launches()
    xxh3_torch.xxh3_64_batch(_xxh3_streams([300, 5000], 23), cuda)
    xxh3_torch.xxh3_64(_xxh3_streams([5000], 24)[0], cuda)
    assert launches(mark) == {"xxh3_batch": 1, "xxh3_stream": 1}


_XXH3_CASES = xxh3_cases.cases()


@pytest.mark.parametrize("name", list(_XXH3_CASES))
def test_xxh3_batch_kernel_matches_plain_on_cases(cuda, name):
    """Every batch of ``xxh3_cases.py``: the valid rows equal the plain
    version and the host XXH3; the rejected ones read nothing and give
    zeros."""
    case = _XXH3_CASES[name]
    flat, rows = torch.from_numpy(case.flat).to(cuda), torch.from_numpy(case.rows).to(cuda)
    acc, hashes = xxh3_torch.accumulate_batch(flat, rows, xxh3_torch.secret_tensor(cuda))
    valid = torch.from_numpy(case.valid).to(cuda)
    want_acc, want_hashes = xxh3_torch.hash_batch_plain(flat, rows[valid])
    torch.cuda.synchronize()
    assert torch.equal(acc[valid], want_acc) and torch.equal(hashes[valid], want_hashes)
    assert not acc[~valid].any() and not hashes[~valid].any()
    assert hashes[valid].cpu().numpy().view(np.uint64).tolist() == [
        H.xxh3_64(s) for s in xxh3_cases.streams(case)]


def test_xxh3_batch_launches_a_cta_a_row(cuda):
    shape = xxh3_torch.batch_shape(128)
    assert shape["grid"] == 128 and shape["threads"] == 256 and shape["per_sm"] >= 1


def _huff_streams():
    """Ragged literal streams over different alphabets, one of 65,536 and
    one of 100,000 symbols, with their host Huffman tables."""
    rng = np.random.default_rng(30)
    streams, tables = [], []
    for n, nsym in [(1, 2), (31, 5), (64, 48), (333, 100), (1000, 256), (5000, 30),
                    (65536, 48), (100000, 200), (7, 3)]:
        s = rng.choice(np.arange(nsym, dtype=np.uint8), size=n,
                       p=rng.dirichlet(np.ones(nsym) * 0.3)).astype(np.uint8)
        s[: min(n, 2)] = [0, 1][: min(n, 2)]  # at least two symbols
        t = zhuf.build_encode_table(np.bincount(s, minlength=256))
        if t is not None:
            streams.append(s)
            tables.append(t)
    return streams, tables


def test_huffman_encode_kernel_matches_plain(cuda):
    streams, tables = _huff_streams()
    assert max(map(len, streams)) == 100000 and 65536 in map(len, streams)
    batch = huffman_torch.build_batch(streams, tables)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in huffman_torch.BATCH_ARGS]
    got = huffman_torch.encode_streams(*args, n_words=batch["n_words"])
    want = huffman_torch.encode_streams_plain(*args, n_words=batch["n_words"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].cpu().numpy().tolist() == batch["rows"][:, 3].tolist()
    enc = huffman_torch.TorchHuffmanEncoder(cuda)
    assert enc.encode_batch(streams, tables) == [
        zhuf._encode_stream(s, t) for s, t in zip(streams, tables)]


_HUFFMAN_ENCODE_CASES = huffman_encode_cases.cases()


@pytest.mark.parametrize("name", list(_HUFFMAN_ENCODE_CASES))
def test_huffman_encode_kernel_matches_plain_on_cases(cuda, name):
    """Every batch of ``huffman_encode_cases.py``; the bytes equal the host
    oracle's."""
    case = _HUFFMAN_ENCODE_CASES[name]
    b = huffman_encode_cases.batch(case)
    args = [torch.from_numpy(b[k]).to(cuda) for k in huffman_torch.BATCH_ARGS]
    got = huffman_torch.encode_streams(*args, n_words=b["n_words"])
    want = huffman_torch.encode_streams_plain(*args, n_words=b["n_words"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    enc = huffman_torch.TorchHuffmanEncoder(cuda)
    assert getattr(enc, case.method)(case.items, case.tables) == \
        huffman_encode_cases.host_payloads(case)


def test_huffman_encode_kernel_writes_every_word_once_and_no_other(cuda):
    """No memset: the kernel stores every word of the plane (a plane filled
    with ones comes back equal to the plain version's), and nothing beside
    it (the guard words around it keep their ones)."""
    case = _HUFFMAN_ENCODE_CASES["tiny streams beside a long one"]
    b = huffman_encode_cases.batch(case)
    args = [torch.from_numpy(b[k]).to(cuda) for k in huffman_torch.BATCH_ARGS]
    guarded = torch.full((b["n_words"] + 64,), -1, dtype=torch.int32, device=cuda)
    total = torch.empty(len(b["rows"]), dtype=torch.int32, device=cuda)
    huffman_torch._encode_launch(args, guarded[32:-32], total)
    want = huffman_torch.encode_streams_plain(*args, n_words=b["n_words"])
    torch.cuda.synchronize()
    assert torch.equal(guarded[32:-32], want[0]) and torch.equal(total, want[1])
    assert (guarded[:32] == -1).all() and (guarded[-32:] == -1).all()


def test_huffman_encode_raises_when_the_totals_disagree(cuda, monkeypatch):
    case = _HUFFMAN_ENCODE_CASES["group and tile edges"]
    build = huffman_torch.build_batch

    def off_by_one(streams, tables):
        b = build(streams, tables)
        b["rows"][2, 3] += 1
        return b

    monkeypatch.setattr(huffman_torch, "build_batch", off_by_one)
    with pytest.raises(RuntimeError, match="disagree"):
        huffman_torch.TorchHuffmanEncoder(cuda).encode_batch(case.items, case.tables)


def _seq_blocks():
    """Sequence blocks in every table mode: random (custom FSE), a long one
    of 5,000 sequences, n = 1, all-RLE, and one in the predefined range."""
    rng = np.random.default_rng(31)

    def block(n, ll_hi=300, ml_hi=80, of_hi=70000):
        return (rng.integers(0, ll_hi, n), rng.integers(3, ml_hi, n), rng.integers(1, of_hi, n))

    blocks = [block(int(rng.integers(1, 300))) for _ in range(6)]
    blocks += [block(5000), block(1), block(500, 8, 12, 40),
               (np.full(40, 5), np.full(40, 4), np.full(40, 1))]
    blocks = [tuple(np.asarray(x, np.int64).tolist() for x in b) for b in blocks]
    return blocks, [zenc.sequence_section_header(*b)[1] for b in blocks]


def test_fse_encode_kernel_matches_plain(cuda):
    blocks, tables = _seq_blocks()
    assert any(t.al == 0 for ts in tables for t in ts)
    batch = fse_torch.build_batch(blocks, tables)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in fse_torch.BATCH_ARGS]
    got = fse_torch.encode_seq_streams(*args, n_words=batch["n_words"])
    want = fse_torch.encode_seq_streams_plain(*args, n_words=batch["n_words"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    enc = fse_torch.TorchSequenceEncoder(cuda)
    assert enc.encode_batch(blocks, tables) == [
        zseq.encode_sequences(*b, *t) for b, t in zip(blocks, tables)]


_FSE_ENCODE_CASES = fse_encode_cases.cases()


@pytest.mark.parametrize("cap", [None, 64])
@pytest.mark.parametrize("name", list(_FSE_ENCODE_CASES))
def test_fse_encode_kernel_matches_plain_on_cases(cuda, monkeypatch, name, cap):
    """Every batch of ``fse_encode_cases.py``, with the stage as the wrapper
    sizes it and with the cap at 64 sequences (every longer block's codes
    and states in the global scratch); the bytes equal the host oracle's."""
    if cap:
        monkeypatch.setattr(fse_torch, "ENCODE_STAGE_CAP", cap)
    case = _FSE_ENCODE_CASES[name]
    batch = fse_torch.build_batch(case.blocks, case.tables)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in fse_torch.BATCH_ARGS]
    got = fse_torch.encode_seq_streams(*args, n_words=batch["n_words"])
    want = fse_torch.encode_seq_streams_plain(*args, n_words=batch["n_words"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fse_torch.TorchSequenceEncoder(cuda).encode_batch(case.blocks, case.tables) == [
        zseq.encode_sequences(*b, *t) for b, t in zip(case.blocks, case.tables)]


def test_fse_encode_holds_two_ctas_an_sm_at_the_cap(cuda):
    assert fse_torch.encode_ctas_per_sm(fse_torch.ENCODE_STAGE_CAP) >= 2


def test_compress_zstd_on_cuda_launches_both_kernels(cuda):
    rng = np.random.default_rng(32)
    rec = np.zeros((20000, 32), np.uint8)
    rec[:, 0] = 0x7F
    rec[:, 1] = np.arange(20000) % 17
    rec[:, 6:14] = rng.integers(0, 4, (20000, 8))
    data = (_text(600000, 33) + rec.tobytes()
            + rng.integers(0, 256, 200000, dtype=np.uint8).tobytes() + bytes(70001))
    dc = DeviceCompressor(cuda)
    mark = launches()
    got = dc.compress_zstd(data, 3)
    run = launches(mark)
    assert run["huffman_encode"] > 0 and run["fse_encode"] > 0
    assert got == dc.compress_zstd(data, 3, device_entropy=False)
    assert native.zstd_decompress(got, len(data)) == data


def _huff_decode_table(et):
    """The decode table of a host encode table (its weights plus the
    implied last one)."""
    total = sum((1 << (w - 1)) for w in et.weights if w > 0)
    return zhuf.build_decode_table(et.weights + [((1 << total.bit_length()) - total).bit_length()])


def test_huffman_decode_kernel_matches_plain(cuda):
    streams, tables = _huff_streams()
    payloads = [zhuf._encode_stream(s, t) for s, t in zip(streams, tables)]
    dts = [_huff_decode_table(t) for t in tables]
    n = [len(s) for s in streams]
    n[2] += 30  # over-reads: final != 0 on both
    size = np.array(n[::-1]) + 5  # placed in reverse order, 5 bytes apart
    dst = (np.cumsum(size) - size)[::-1].tolist()
    batch = huffman_torch.build_decode_batch(payloads, dts, n, dst)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in huffman_torch.DECODE_ARGS]
    n_out = int(size.sum())
    got = huffman_torch.decode_streams(*args, n_out=n_out)
    want = huffman_torch.decode_streams_plain(*args, n_out=n_out)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][2] != 0 and int((got[1] != 0).sum()) == 1
    dec = huffman_torch.TorchHuffmanDecoder(cuda)
    out = dec.decode_batch(payloads, dts, [len(s) for s in streams])
    assert all(np.array_equal(o, s) for o, s in zip(out, streams))


_HUFFMAN_CASES = huffman_cases.cases()


@pytest.mark.parametrize("name", list(_HUFFMAN_CASES))
def test_huffman_decode_kernel_matches_plain_on_adversarial_batches(cuda, name):
    """Every batch of ``huffman_cases.py``, the row above the stage cap
    (read from global memory) and the malformed rows among them, at two
    alignments of the payload, with the stage size given and read back."""
    case = _HUFFMAN_CASES[name]
    b = case.batch
    for lead in (0, 7):
        rows = b["rows"].copy()
        rows[rows[:, 0] >= 0, 0] += lead
        payload = np.concatenate([np.full(lead, 0xA5, np.uint8), b["payload"]])
        args = [torch.from_numpy(a).to(cuda) for a in (payload, rows, b["tables"])]
        want = huffman_torch.decode_streams_plain(*args, n_out=b["n_out"])
        for widest in (b["widest"], None):
            got = huffman_torch.decode_streams(*args, n_out=b["n_out"], widest=widest)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (lead, widest)
    for f, e in zip(got[1].cpu().tolist(), case.expect):
        assert {"ok": f == 0, "empty": f == 0, "over-read": f < 0, "unconsumed": f > 0,
                "malformed": f == -1}[e], (f, e)


def _zstd_items():
    """The sequence items of the repo's native zstd frames of text,
    records and noise: custom, predefined, RLE and repeat tables."""
    rng = np.random.default_rng(40)
    rec = np.zeros((9000, 32), np.uint8)
    rec[:, 0] = 0x7F
    rec[:, 1] = np.arange(9000) % 17
    rec[:, 6:14] = rng.integers(0, 4, (9000, 8))
    data = (_text(300000, 41) + rec.tobytes()
            + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes() + b"ab" * 20000)
    return extract.walk_zstd(native.zstd_compress(data, 3)).seq_items


def test_fse_decode_kernel_matches_plain(cuda):
    items = _zstd_items()
    bs, ll, of, ml, nb = items[0]
    items = items + [(bs[len(bs) // 2:], ll, of, ml, nb), (b"\x5a" + bs, ll, of, ml, nb),
                     (bs, ll, zfse.build_rle_table(31), ml, nb)]
    batch = fse_torch.build_decode_batch(items)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in fse_torch.DECODE_ARGS]
    got = fse_torch.decode_seq_streams(*args)
    want = fse_torch.decode_seq_streams_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pos_f, err = got[3].cpu(), got[4].cpu()
    assert (pos_f[:-3] == 0).all() and pos_f[-3] < 0 and pos_f[-2] > 0
    assert err.tolist() == [False] * (len(items) - 1) + [True]


@pytest.mark.parametrize("name", list(fse_cases.cases()))
def test_fse_decode_kernel_matches_plain_on_adversarial_batches(cuda, name):
    """Every batch of ``fse_cases.py``, the row above the stage cap (read
    from global memory) among them, at two alignments of the rows."""
    case = fse_cases.cases()[name]
    for lead in (0, 7):
        items = [(b"\x01" * lead + case.items[0][0], *case.items[0][1:]), *case.items[1:]]
        batch = fse_torch.build_decode_batch(items)
        args = [torch.from_numpy(batch[k]).to(cuda) for k in fse_torch.DECODE_ARGS]
        args[1][0] += torch.tensor([lead, -lead, -8 * lead], device=cuda)  # after the lead
        got = fse_torch.decode_seq_streams(*args)
        want = fse_torch.decode_seq_streams_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, lead)
    pos_f, err = got[3].cpu(), got[4].cpu()
    for i, e in enumerate(case.expect):
        assert bool(err[i]) == (e == "offset code")
        assert e != "ok" or pos_f[i] == 0


def test_fse_decode_kernel_on_a_batch_with_no_sequence(cuda):
    item = fse_cases.cases()["predefined"].items[0]
    batch = fse_torch.build_decode_batch([(item[0], *item[1:4], 0)] * 3)
    args = [torch.from_numpy(batch[k]).to(cuda) for k in fse_torch.DECODE_ARGS]
    got = fse_torch.decode_seq_streams(*args)
    want = fse_torch.decode_seq_streams_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].numel() == 0 and torch.equal(got[3].cpu(), args[1][:, 2].cpu().to(torch.int32))


def test_rep_kernels_match_plain(cuda):
    rng = np.random.default_rng(42)
    nsq = rng.integers(0, 3000, 40)
    nsq[0], nsq[5] = 100, 0
    total = int(nsq.sum())
    ovs = np.where(rng.random(total) < 0.55, rng.integers(1, 4, total),
                   rng.integers(4, 70000, total)).astype(np.int32)
    lls = np.where(rng.random(total) < 0.3, 0, rng.integers(1, 50, total)).astype(np.int32)
    mls = rng.integers(3, 300, total).astype(np.int32)
    ovs[0], lls[0] = 3, 0  # r0 - 1: underflows from the entry state (1, 4, 8)
    seq_off = torch.from_numpy(np.concatenate([[0], np.cumsum(nsq)]).astype(np.int64)).to(cuda)
    ov, ll, ml = (torch.from_numpy(a).to(cuda) for a in (ovs, lls, mls))
    got = fse_torch.rep_totals(ov, ll, ml, seq_off)
    want = fse_torch.rep_totals_plain(ov, ll, ml, seq_off)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for base in (100000, 0):  # without and with an underflow
        entry = torch.tensor([[1 + base, 4 + base, 8 + base]] * 40, dtype=torch.int32, device=cuda)
        got = fse_torch.rep_apply(ov, ll, seq_off, entry)
        want = fse_torch.rep_apply_plain(ov, ll, seq_off, entry)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(got[1].any()) == (base == 0)
    # blocks on both sides of the scan's warp and tile lengths, in one launch
    for underflow in ("none", "first", "last"):
        ovs, lls, mls, seq_off, entry = rep_edge_case(REP_EDGE_LENGTHS + [7], underflow)
        ov, ll, ml, seq_off, entry = (torch.from_numpy(a).to(cuda)
                                      for a in (ovs, lls, mls, seq_off, entry))
        got = fse_torch.rep_totals(ov, ll, ml, seq_off)
        want = fse_torch.rep_totals_plain(ov, ll, ml, seq_off)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), underflow
        got = fse_torch.rep_apply(ov, ll, seq_off, entry)
        want = fse_torch.rep_apply_plain(ov, ll, seq_off, entry)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), underflow
        assert bool(got[1].any()) == (underflow != "none")


_REPLAY_CASES = replay_cases.cases()


@pytest.mark.parametrize("name", sorted(_REPLAY_CASES))
def test_replay_kernel_matches_plain_on_adversarial_rows(cuda, name):
    """Copy chains, sources at chunk edges, literal-only segments, every row
    shape: the kernel equals ``replay_plain``, exact, and raises nothing (its
    error word stays clear)."""
    batch = _REPLAY_CASES[name]
    args = [torch.from_numpy(batch[k]).to(cuda) for k in lz4_torch.REPLAY_ARGS]
    mark = launches()
    got = lz4_torch.replay(*args, n_out=batch["n_out"])
    want = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
    torch.cuda.synchronize()
    assert launches(mark)["lz4_replay"] == 1
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), replay_cases.replay_bytewise(batch))


def test_replay_kernel_matches_plain_on_long_rows(cuda):
    """Rows of 100 to 300 KiB, past the kernel's shared-memory size."""
    raws = [_text(300000, 43), (b"0123456789abcdef" * 8000)[:100001],
            b"z" * 70000 + _text(90000, 44)]
    batch = lz4_torch.build_batch([lz4block.compress_block(r) for r in raws],
                                  [len(r) for r in raws])
    assert batch["n_out"] > 65536
    args = [torch.from_numpy(batch[k]).to(cuda) for k in lz4_torch.REPLAY_ARGS]
    got = lz4_torch.replay(*args, n_out=batch["n_out"])
    want = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = got.cpu().numpy()
    assert [out[i, : len(r)].tobytes() for i, r in enumerate(raws)] == raws


_PARSE_CASES = lz4_parse_cases.cases()


def _parse_outcome(fn):
    try:
        return fn(), None
    except DecompressError as e:
        return None, str(e)


def _hold_parse(cuda, blocks, sizes):
    """The CUDA parse against ``build_batch``: every table exact, or the
    same first error; returns the outcome."""
    flat, offsets = lz4_torch.pack_blocks(blocks)
    mark = launches()
    got, err = _parse_outcome(lambda: lz4_torch.parse_batch(flat.to(cuda), offsets, sizes))
    want, werr = _parse_outcome(lambda: lz4_torch.build_batch(blocks, sizes))
    torch.cuda.synchronize()
    assert err == werr
    assert launches(mark)["lz4_parse"] == (err is None)
    if err is None:
        assert got["n_out"] == want["n_out"]
        assert np.array_equal(got["out_len_host"], want["out_len"][:len(blocks)])
        for k in lz4_torch.REPLAY_ARGS:
            g = got[k].cpu().numpy()
            assert g.dtype == want[k].dtype and np.array_equal(g, want[k]), k
    return got, err


@pytest.mark.parametrize("name", list(_PARSE_CASES))
def test_parse_kernel_matches_build_batch_on_cases(cuda, name):
    """Length edges, 65,535-long runs, the count bound, a row above the
    stage cap, every error (a parse error in a later block beside a size
    error in an earlier one, an offset before the block start), mixed
    batches: the kernel's tables equal ``build_batch``'s, and its errors
    are the CPU route's, message and order."""
    case = _PARSE_CASES[name]
    _, err = _hold_parse(cuda, case.blocks, case.sizes)
    assert err == case.expect


def test_parse_kernel_matches_build_batch_on_a_corpus_frame(cuda):
    """The blocks of a 4 MiB frame written by the device compressor."""
    rng = np.random.default_rng(47)
    data = _text(1 << 21, 48) + rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes() \
        + (b"0123456789abcdef" * 65536)
    frame = DeviceCompressor(cuda).compress(data)
    _, blocks, bounds, _ = extract.walk_lz4f(frame)
    assert len(blocks) >= 40
    got, err = _hold_parse(cuda, blocks, bounds)
    assert err is None and got["seg_start"].shape[0] == 64


@pytest.mark.parametrize("group", lz4_torch.PARSE_GROUPS)
@pytest.mark.parametrize("name", ["mixed: tiny and empty rows, rows at and above the stage cap",
                                  "mixed: every valid block", "mixed: every block"])
def test_parse_kernel_matches_build_batch_in_every_grouping(cuda, monkeypatch, name, group):
    """The walk with 1, 2, 4 or 8 rows a CTA (staged rows of every size
    beside empty rows and rows read from global memory in one CTA): the
    tables of ``build_batch``, or its first error."""
    monkeypatch.setattr(lz4_torch, "PARSE_GROUPS", (group,))
    case = _PARSE_CASES[name]
    _, err = _hold_parse(cuda, case.blocks, case.sizes)
    assert err == case.expect


def test_parse_walk_steps_apart_equal_both_at_once(cuda):
    """The chain alone, then the values alone from its scratch, give the
    info and the records (up to each row's error) of one launch of both."""
    case = _PARSE_CASES["mixed: every block"]
    flat, offsets = lz4_torch.pack_blocks(case.blocks)
    payload = flat.to(cuda)
    w = lz4_torch._parse_walk(payload, offsets)
    info, rec = w["info"].cpu().numpy(), w["rec"].cpu().numpy()
    w["info"].fill_(-1)
    w["rec"].fill_(-1)
    lz4_torch._walk_launch(payload, w, 1)
    lz4_torch._walk_launch(payload, w, 2)
    torch.cuda.synchronize()
    assert np.array_equal(w["info"].cpu().numpy(), info)
    assert (info[:, 3] > 0).sum() > 10
    got, off = w["rec"].cpu().numpy(), w["rec_off"].cpu().numpy()
    for b, n in enumerate(info[:, 0]):
        assert np.array_equal(got[off[b]:off[b] + n], rec[off[b]:off[b] + n]), b


def test_parse_walk_holds_a_corpus_frame_in_one_wave(cuda):
    """The blocks of an 8 MiB frame: every walker resident at once, in CTAs
    of the plan's rows, and the records as ``build_batch`` lays them out."""
    data = _text(1 << 22, 53) + np.random.default_rng(54).integers(
        0, 256, 1 << 22, dtype=np.uint8).tobytes()
    frame = DeviceCompressor(cuda).compress(data)
    _, blocks, bounds, _ = extract.walk_lz4f(frame)
    flat, offsets = lz4_torch.pack_blocks(blocks)
    plan = lz4_torch._parse_walk(flat.to(cuda), offsets)["plan"]
    assert plan["waves"] == 1 and plan["resident"] == len(blocks)
    assert plan["ctas"] == -(-len(blocks) // plan["group"])
    got, err = _hold_parse(cuda, blocks, bounds)
    assert err is None


def test_lz4_extract_on_cuda_runs_no_host_parse(cuda, monkeypatch):
    """On the CUDA route the per-token Python parse never runs: the
    replayer decodes with it raising, through the parse and replay kernels."""
    def host_parse(data):
        raise AssertionError("parse_block_sequences called on the CUDA route")

    monkeypatch.setattr(lz4_torch, "parse_block_sequences", host_parse)
    raws = [_text(65536, 49), b"a" * 5000, b"", _text(300000, 50)]
    blocks = [lz4block.compress_block(r) for r in raws]
    mark = launches()
    got = lz4_torch.DeviceLZ4Replayer(cuda).decompress_blocks(blocks, [len(r) for r in raws])
    assert got == raws
    run = launches(mark)
    assert run["lz4_parse"] == 1 and run["lz4_replay"] == 1
    data = _text(1 << 20, 51)
    engine.install(cuda)
    try:
        w = Writer.to_heap()
        w.write_archive([("d.bin", data, CompressOptions(CompressionMethod.LZ4, 1))])
        assert Reader.from_memory(w.buffer, shared=True).read_file("d.bin") == data
    finally:
        engine.uninstall()
    assert launches(mark)["lz4_parse"] == 2


def test_lz4_replayer_errors_on_cuda_match_the_cpu_route(cuda):
    """The replayer raises what the CPU route raises: a parse error in a
    later block before a size error in an earlier one, and an offset
    before the block start before any replay."""
    bad = bytes([0x10, 0x61, 0x05, 0x00, 0x50]) + b"bcdef"
    good = lz4block.compress_block(_text(5000, 52))
    for blocks, sizes in (([good, good, b"\x10a\x00\x00\x00"], [4999, 5000, 100]),
                          ([good, bad], [5000, 100]), ([good, good], [5000, 4999])):
        want = _parse_outcome(lambda: lz4_torch.DeviceLZ4Replayer("cpu").decompress_blocks(
            blocks, sizes))[1]
        mark = launches()
        with pytest.raises(DecompressError) as e:
            lz4_torch.DeviceLZ4Replayer(cuda).decompress_blocks(blocks, sizes)
        assert str(e.value) == want
        assert launches(mark)["lz4_replay"] == 0


#: the LZ4 routes' edges, as the desktop tree's test holds them on the CPU:
#: under ``DEVICE_MIN`` the host route, from it up the card's (a last block
#: of one byte at 64 KiB + 1 and 128 KiB + 1), and three random blocks
#: stored raw
LZ4_EDGE_SIZES = {"one": 1, "under": 65535, "at": 65536, "over": 65537, "two": 131073,
                  "media": 196608}
LZ4_ROUTES = ("lz4.compress.device", "lz4.compress.host", "lz4.decompress.device",
              "lz4.decompress.host")


def _lz4_route_counts() -> dict:
    snap = metrics.snapshot()
    return {n: (snap[n]["calls"], snap[n]["bytes"]) if n in snap else (0, 0) for n in LZ4_ROUTES}


@pytest.mark.parametrize("name", list(LZ4_EDGE_SIZES))
def test_lz4_edge_sizes_on_cuda_equal_the_host_frames(cuda, name):
    """Each edge entry written and read through the Writer and Reader with
    the card installed gives its content, as the host route's frames do;
    the host decoder reads the card's frames; each step counts the route
    its size names, once, with its bytes, and the card's route launches
    the tokenizer and the serializer once each."""
    size = LZ4_EDGE_SIZES[name]
    data = (np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
            if name == "media" else _text(size + 8, 55)[:size])
    opts = CompressOptions(CompressionMethod.LZ4, 1)
    engine.uninstall()
    host = Writer.to_heap()
    host.write_archive([(name, data, opts)])
    engine.install(cuda)
    try:
        c0, mark = _lz4_route_counts(), launches()
        w = Writer.to_heap()
        w.write_archive([(name, data, opts)])
        c1, made, mark = _lz4_route_counts(), launches(mark), launches()
        got = Reader.from_memory(w.buffer).read_file(name)
        c2, read = _lz4_route_counts(), launches(mark)
        from_host = Reader.from_memory(host.buffer).read_file(name)
    finally:
        engine.uninstall()
    assert got == data and from_host == data
    assert Reader.from_memory(w.buffer).read_file(name) == data  # the host decoder
    route = "device" if size >= 65536 else "host"
    step = {n: (c1[n][0] - c0[n][0], c1[n][1] - c0[n][1]) if ".compress." in n
            else (c2[n][0] - c1[n][0], c2[n][1] - c1[n][1]) for n in LZ4_ROUTES}
    assert step == {n: (1, size) if n.endswith(route) else (0, 0) for n in LZ4_ROUTES}
    if route == "host":
        assert w.buffer == host.buffer and not read
    else:
        # one step of the pipeline: one tokenizer launch and the serializer's
        assert made == {"lz4_tokenize": 1, "lz4_serialize": 1}
        # raw blocks alone leave nothing to parse or replay
        want = 0 if name == "media" else 1
        assert (read["lz4_parse"], read["lz4_replay"]) == (want, want)


def test_reader_reads_zstd_on_cuda_through_all_four_kernels(cuda):
    rng = np.random.default_rng(45)
    data = _text(3 << 20, 46) + rng.integers(0, 256, 300000, dtype=np.uint8).tobytes()
    engine.install(cuda)
    try:
        w = Writer.to_heap()
        w.write_archive([("z.bin", data, CompressOptions(CompressionMethod.ZSTD, 3))])
        mark = launches()
        port_zstd.reset_fallbacks()
        r = Reader.from_memory(w.buffer, shared=True)
        assert r.read_file("z.bin") == data
    finally:
        engine.uninstall()
    run = launches(mark)
    for k in ("huffman_decode", "fse_decode", "rep_totals", "rep_apply", "lz4_replay"):
        assert run[k] > 0, k
    assert port_zstd.FALLBACKS == {"device_to_host": 0}


@pytest.mark.parametrize("name", sorted(assemble_cases.cases()))
def test_assembly_kernels_match_plain_on_cases(cuda, name):
    """stitch, layout and trim against their plain versions: every output,
    the record, each frame's segments, the literal rows; the trimmed bytes
    where every check passed (past a failed check the replay's input is
    garbage, on which the kernel and the plain replay differ)."""
    case = assemble_cases.cases()[name]
    want = assemble_cases.assemble(case, "cpu")
    mark = launches()
    got = assemble_cases.assemble(case, cuda)
    torch.cuda.synchronize()
    assert launches(mark)["zstd_stitch"] == 1
    assert launches(mark)["zstd_trim"] == 1
    for k in ("entry", "bases", "frame_out", "rec", "lits"):
        assert np.array_equal(got[k], want[k]), k
    for g, w in zip(got["segs"], want["segs"]):
        assert np.array_equal(g, w)
    if assemble_torch.first_error(want["rec"]) is None:
        assert np.array_equal(got["out"], want["out"])


def _strip_size(frame: bytes) -> bytes:
    """A frame of the port's encoder above 256 KiB (a window descriptor and
    a 4-byte size) without its declared size."""
    assert frame[4] == 0x80
    return frame[:4] + b"\x00" + frame[5:6] + frame[10:]


def _waits() -> tuple:
    snap = metrics.snapshot()
    return (sum(v["calls"] for k, v in snap.items() if k.endswith(".wait")),
            snap.get("torch.zstd_resize", {}).get("calls", 0))


def test_zstd_route_waits_once_and_resizes_without_a_size(cuda):
    """One wait a read where every frame declares its size, two and a
    resize where one does not or declares a wrong one; the bytes and the
    errors of the CPU route in each case."""
    data = _text(600_000, 61)
    frame = native.zstd_compress(data, 3)
    cases = {"declared": (frame, (1, 0)), "no size": (_strip_size(frame), (2, 1)),
             "wrong size": (frame[:6] + (len(data) + 5).to_bytes(4, "little") + frame[10:],
                            (2, 1)),
             "two frames": (frame + native.zstd_compress(data[:5000], 3), (1, 0))}
    for name, (comp, counts) in cases.items():
        want = extract.decompress_zstd_device(comp, device="cpu")
        metrics.reset()
        assert extract.decompress_zstd_device(comp, device=cuda) == want, name
        assert _waits() == counts, name
    bad = bytearray(_strip_size(frame))
    bad[len(bad) // 2] ^= 0x5A
    assert _route_outcome(bytes(bad), len(data), cuda) == \
        _route_outcome(bytes(bad), len(data), "cpu")


def _route_outcome(data: bytes, max_out: int, dev):
    """The zstd route's bytes on ``dev``, or its error's type and message."""
    try:
        return extract.decompress_zstd_device(data, max_out, device=dev)
    except (DecompressError, RuntimeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("part", range(4))
def test_zstd_route_gives_the_cpus_outcome_on_the_flip_sweeps(cuda, part):
    """The corruption sweeps (``assemble_cases.flips``) of a frame of the
    port's encoder, a quarter a case: each of the 304 inputs gives on the
    card the bytes or the first error it gives on the CPU, and the card
    reports no fault when synchronised after it (every kernel past a
    failed check runs on what the failed one left)."""
    rng = np.random.default_rng(64)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8)) for _ in range(200)]
    data = b" ".join(words[i] for i in rng.integers(0, 200, 7_500))[:30_000]
    frame = native.zstd_compress(data, 3)
    for k, bad in enumerate(assemble_cases.flips(frame)[part::4]):
        want = _route_outcome(bad, len(data), "cpu")
        got = _route_outcome(bad, len(data), cuda)
        torch.cuda.synchronize()
        assert got == want, (part + 4 * k, got if isinstance(got, tuple) else len(got))


def test_zstd_route_stages_back_to_back_reads_apart(cuda):
    """Two uploads through the staging while the stream is held by a long
    kernel: the second's host buffer is not the first's while the first
    copy is in flight, and each lands whole."""
    a = {"x": np.arange(300_000, dtype=np.int64), "y": np.frombuffer(b"first" * 999, np.uint8)}
    b = {"x": -np.arange(300_000, dtype=np.int64), "y": np.frombuffer(b"other" * 999, np.uint8)}
    torch.cuda._sleep(200_000_000)  # holds the stream some 100 ms
    da = extract.stage(a, cuda)
    db = extract.stage(b, cuda)
    torch.cuda.synchronize()
    for d, h in ((da, a), (db, b)):
        for k in h:
            assert np.array_equal(d[k].cpu().numpy(), h[k]), k
    assert da["x"].data_ptr() != db["x"].data_ptr()


def test_zstd_read_on_cuda_launches_the_assembly_and_copies_nothing_pageable(cuda):
    """A read of the Silesia cell's shape: the three assembly kernels, one
    wait, and every copy between host and card from or to pinned memory."""
    rng = np.random.default_rng(62)
    data = _text(3 << 20, 63) + rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    comp = native.zstd_compress(data, 3)
    assert extract.decompress_zstd_device(comp, len(data), device=cuda) == data
    metrics.reset()
    mark = launches()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert extract.decompress_zstd_device(comp, len(data), device=cuda) == data
        torch.cuda.synchronize()
    run = launches(mark)
    assert {k: run[k] for k in ("zstd_stitch", "zstd_layout", "zstd_trim")} == \
        {"zstd_stitch": 1, "zstd_layout": 1, "zstd_trim": 1}
    assert _waits() == (1, 0)
    names = [e.name for e in prof.events()]
    assert not [n for n in names if "Pageable" in n], sorted(set(names))


# ---------------------------------------------------------------------------
# The zstd read's native enqueue (kernels/zstd_chain.py, csrc/zstd_chain.cu)
# ---------------------------------------------------------------------------

#: PERF.md section 5's sizes and the desktop tree's kinds
_TREE_SIZES = (4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
_TREE_KINDS = ("text", "markup", "records", "binary", "media")


def _tree_entry(kind: str, size: int) -> tuple:
    from zbench.gen import desktop

    data = desktop.generate(np.random.default_rng([_TREE_KINDS.index(kind), size]), size,
                            {"content": kind}, None).tobytes()
    return port_zstd.ZstdCodec().compress(data, 3), data


def _native_read(comp: bytes, n: int, cuda) -> bytes:
    """A read through ``decompress_zstd_device`` that must take the native
    enqueue: one ``torch.zstd_enqueue``, none of the Python route's phases."""
    metrics.reset()
    out = extract.decompress_zstd_device(comp, n, device=cuda)
    snap = metrics.snapshot()
    assert snap["torch.zstd_enqueue"]["calls"] == 1
    assert not {"torch.zstd_stage", "torch.huffman_decode", "torch.fse_decode",
                "torch.rep_resolve", "torch.replay"} & set(snap)
    return out


@pytest.mark.parametrize("kind", _TREE_KINDS)
def test_native_enqueue_returns_the_native_decoders_bytes_at_every_size(cuda, kind):
    for size in _TREE_SIZES:
        comp, data = _tree_entry(kind, size)
        assert _native_read(comp, size, cuda) == native.zstd_decompress(comp, size) == data, \
            size


def test_native_enqueue_launches_and_waits_as_the_python_route(cuda):
    """On every kind at 4 KiB and 1 MiB, an empty and a multi-frame entry:
    the same bytes, one wait, and the same ``launch.*`` keys and counts
    under the read as the Python route's wrappers record."""
    entries = [_tree_entry(kind, size) for kind in _TREE_KINDS for size in (4 << 10, 1 << 20)]
    text = _text(100_000, 71)
    entries += [(native.zstd_compress(b"", 3), b""),
                (b"".join(native.zstd_compress(text[i:i + 30_000], 3)
                          for i in range(0, 100_000, 30_000)), text)]
    for comp, data in entries:
        assert _native_read(comp, len(data), cuda) == data  # the registry reset first
        assert _waits() == (1, 0)
        got = launches()
        metrics.reset()
        assert extract._decode_python(extract.zstd_plan(comp), len(data), cuda) == data
        assert got == launches(), len(data)


def test_native_enqueue_gives_the_exact_and_resize_paths_bytes(cuda):
    """A frame without its size (the record read back after part A, then
    part B) and one whose size is wrong (the stitch again, then part B):
    the bytes of the declared frame, the CPU route's waits and resizes,
    and, on a corrupted frame without a size, the CPU route's error."""
    data = _text(300_000, 72)
    frame = native.zstd_compress(data, 3)
    wrong = frame[:6] + (len(data) + 9).to_bytes(4, "little") + frame[10:]
    for comp, want, counts in ((frame, data, (1, 0)), (_strip_size(frame), data, (2, 1)),
                               (wrong, data, (2, 1)),
                               (_strip_size(frame) + frame, data * 2, (2, 1))):
        assert _native_read(comp, None, cuda) == want
        assert _waits() == counts
    for p in np.linspace(20, len(frame) - 5, 3).astype(int).tolist():
        bad = bytearray(_strip_size(frame))
        bad[p] ^= 0x5A
        assert _route_outcome(bytes(bad), len(data), cuda) == \
            _route_outcome(bytes(bad), len(data), "cpu"), p


def test_native_reads_back_to_back_keep_their_buffers(cuda):
    """Reads back to back behind a long kernel, and four threads reading at
    once, each on a stream of its own: every read returns its own entry,
    so no read's pinned upload, arena or read-back is another's."""
    import threading

    entries = [_tree_entry(kind, size) for kind in _TREE_KINDS for size in (16 << 10, 256 << 10)]
    torch.cuda._sleep(200_000_000)  # holds the stream some 100 ms
    for comp, data in entries * 2:
        assert extract.decompress_zstd_device(comp, len(data), device=cuda) == data
    bad = []

    def reader(k):
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for i in range(12):
                comp, data = entries[(k + i) % len(entries)]
                if extract.decompress_zstd_device(comp, len(data), device=cuda) != data:
                    bad.append((k, i))

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_native_enqueue_spans_sit_under_the_read(cuda):
    """``torch.zstd_enqueue`` under ``zstd.decompress``, its wait under it,
    and every kernel it records under the enqueue, through Reader.read_file."""
    data = _text(300_000, 73)
    engine.install(cuda)
    try:
        w = Writer.to_heap()
        w.write_archive([("z", data, CompressOptions(CompressionMethod.ZSTD, 3))])
        r = Reader.from_memory(w.buffer)
        metrics.reset()
        assert r.read_file("z") == data
    finally:
        engine.uninstall()
    snap = metrics.snapshot()
    assert snap["torch.zstd_enqueue"]["parents"] == {"zstd.decompress": 1}
    assert snap["torch.zstd_enqueue.wait"]["parents"] == {"torch.zstd_enqueue": 1}
    assert snap["torch.zstd_enqueue"]["bytes"] >= r.get_file_entry("z").comp_size
    kernels = {k: v for k, v in snap.items() if k.startswith("launch.")}
    assert set(kernels) == {f"launch.{k}" for k in zstd_chain.KERNELS}
    assert all(v["parents"] == {"torch.zstd_enqueue": 1} for v in kernels.values())


# ---------------------------------------------------------------------------
# The LZ4 block serializer
# ---------------------------------------------------------------------------

def _hold_serializer(cuda, rows: np.ndarray, arrays, mode: str, n: int,
                     parse: str = "greedy") -> bytes:
    """The kernel's sections on ``rows`` and their tables in ``parse``: one
    launch, equal to the plain version's and to the native serializer's."""
    serialize = (native.lz4_serialize_blocks_hc if parse == "hc"
                 else native.lz4_serialize_blocks_packed)
    want = serialize(rows.reshape(-1)[:n].tobytes(), mode, arrays, rows.shape[1])
    assert lz4_torch.serialize_plain(rows, arrays, mode, n, parse) == want
    mark = launches()
    buf = lz4_torch.serialize_sections(torch.from_numpy(rows).to(cuda),
                                       [torch.from_numpy(a).to(cuda) for a in arrays], mode, n,
                                       parse)
    key = lz4_torch.SERIALIZE_KEYS[lz4_torch.PARSES.index(parse)]
    assert launches(mark) == {key: 1}
    assert buf.shape == (lz4_torch.SERIALIZE_HEADER + n + 4 * len(rows),)
    assert bytes(lz4_torch.sections(buf.cpu())) == want
    return want


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
@pytest.mark.parametrize("name", serialize_cases.NAMES)
def test_serialize_kernel_matches_plain_and_native_on_cases(cuda, name, mode):
    rows, arrays, n = serialize_cases.cases(mode)[name]
    _hold_serializer(cuda, rows, arrays, mode, n)


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
@pytest.mark.parametrize("name", serialize_cases.NAMES + serialize_cases.HC_NAMES)
def test_serialize_kernel_hc_matches_plain_and_native_on_cases(cuda, name, mode):
    """The HC parse on every case, and on the tables of the HC levels."""
    cases = serialize_cases.cases(mode) | serialize_cases.hc_cases(mode)
    rows, arrays, n = cases[name]
    _hold_serializer(cuda, rows, arrays, mode, n, "hc")


@pytest.mark.parametrize("mode,B", [("u16", 4096), ("pair", 4096), ("u16", 8192),
                                    ("pair", 8192), ("pair", 65536)])
def test_serialize_kernel_on_the_tokenizers_tables(cuda, mode, B):
    rng = np.random.default_rng(B)
    data = (_text(3 * B + 1234, 91) + rng.integers(0, 256, B, dtype=np.uint8).tobytes()
            + bytes(B + 17) + (b"xy" * B)[:B - 5] + _text(777, 92))
    nb = -(-len(data) // B)
    rows = np.zeros((nb, B), dtype=np.uint8)
    rows.reshape(-1)[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    arrays, _est = lz4_torch.tokenize_est(torch.from_numpy(rows).to(cuda), 2, lz4_torch.CAPJ, mode)
    body = _hold_serializer(cuda, rows, [a.cpu().numpy() for a in arrays], mode, len(data))
    frame = lz4frame._header(64 << 10, True, False, None) + body + bytes(4)
    assert lz4frame.decompress_frame(frame, len(data)) == data


def test_serialize_kernel_refuses_what_it_cannot_take(cuda):
    rows = torch.zeros((2, 4096), dtype=torch.uint8, device=cuda)
    arrays, _ = lz4_torch.tokenize_est(rows, 2, lz4_torch.CAPJ, "hash")
    with pytest.raises(ValueError, match="wire modes"):
        lz4_torch.serialize_sections(rows, arrays, "hash", 8192)
    arrays, _ = lz4_torch.tokenize_est(rows, 2, lz4_torch.CAPJ, "pair")
    with pytest.raises(ValueError, match="do not fit"):
        lz4_torch.serialize_sections(rows, arrays, "pair", 8193)
    with pytest.raises(ValueError, match="wire arrays"):
        lz4_torch.serialize_sections(rows, arrays[:1], "pair", 8192)


@pytest.mark.parametrize("B", [4096, 8192, 65536])
def test_device_compressor_serializes_on_the_card(cuda, monkeypatch, B):
    """The card's frames are the CPU route's bytes, over several steps, with
    one serializer launch and one wait a shard, the route counted under
    ``torch.serialize``, and the native serializer never called."""
    rng = np.random.default_rng(B + 1)
    data = (_text(20 * B + 99, 93) + rng.integers(0, 256, 3 * B, dtype=np.uint8).tobytes()
            + bytes(2 * B) + _text(5 * B + 7, 94))
    edges = (b"", b"a", _text(12, 95), _text(13, 96), _text(B + 1, 97))
    cpu = DeviceCompressor("cpu", block_size=B)
    want, edge_want = cpu.compress(data), [cpu.compress(d) for d in edges]
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 8 * B)
    monkeypatch.setattr(native, "lz4_serialize_blocks_packed",
                        lambda *a, **k: pytest.fail("the card's route called the host serializer"))
    metrics.reset()
    mark = launches()
    got = DeviceCompressor(cuda, block_size=B).compress(data)
    shards = -(-len(data) // (8 * B))
    run = launches(mark)
    snap = metrics.snapshot()
    assert got == want
    assert lz4frame.decompress_frame(got, len(data)) == data
    assert run["lz4_serialize"] == shards
    assert run[lz4_torch.launch_key("u16" if B <= 8192 else "pair")] == shards
    assert snap["torch.d2h.wait"]["calls"] == shards
    assert snap["lz4.serialize.device"]["calls"] == shards
    assert snap["lz4.serialize.device"]["bytes"] == len(data)
    assert snap["lz4.serialize.device"]["parents"] == {"torch.serialize": shards}
    assert "lz4.serialize.host" not in snap
    assert [DeviceCompressor(cuda, block_size=B).compress(d) for d in edges] == edge_want


@pytest.mark.parametrize("level", [3, 9])
@pytest.mark.parametrize("B", [4096, 65536])
def test_device_compressor_hc_levels_on_the_card(cuda, monkeypatch, B, level):
    """At HC levels the card's frames are the CPU route's bytes: the match
    finder at the level's depth and comparison, the serializer's HC parse,
    one launch of each and one wait a shard, no host serializer."""
    rng = np.random.default_rng(B + level)
    data = (_text(12 * B + 99, 93) + rng.integers(0, 256, 2 * B, dtype=np.uint8).tobytes()
            + bytes(B) + _text(3 * B + 7, 94))
    want = DeviceCompressor("cpu", level, block_size=B).compress(data)
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 8 * B)
    for name in ("lz4_serialize_blocks_packed", "lz4_serialize_blocks_hc"):
        monkeypatch.setattr(native, name,
                            lambda *a, **k: pytest.fail("the card's route called the host serializer"))
    metrics.reset()
    mark = launches()
    got = DeviceCompressor(cuda, level, block_size=B).compress(data)
    shards = -(-len(data) // (8 * B))
    assert got == want
    assert lz4frame.decompress_frame(got, len(data)) == data
    assert launches(mark) == {"lz4_serialize_hc": shards,
                              lz4_torch.launch_key("u16" if B <= 8192 else "pair"): shards}
    assert metrics.snapshot()["torch.d2h.wait"]["calls"] == shards


def test_device_compressor_on_two_shards_serializes_each_on_its_card(cuda, monkeypatch):
    from zpack_tpu_torch.parallel.pipeline import make_mesh

    data = _text(3 << 20, 98) + np.random.default_rng(98).integers(
        0, 256, 700_001, dtype=np.uint8).tobytes()
    want = DeviceCompressor("cpu").compress(data)
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 1 << 20)
    mark = launches()
    got = DeviceCompressor(make_mesh(["cuda:0", "cuda:0"])).compress(data)
    # 58 blocks of 64 KiB, 16 a shard: 4 shards in 2 steps, the last short
    assert launches(mark)["lz4_serialize"] == 4
    assert got == want


# ---------------------------------------------------------------------------
# The device mesh: two shards of one card
# ---------------------------------------------------------------------------


@pytest.fixture
def two_shards(cuda):
    from zpack_tpu_torch.parallel.pipeline import make_mesh

    return make_mesh(["cuda:0", "cuda:0"])


def test_make_mesh_names_every_visible_card(cuda):
    from zpack_tpu_torch.parallel.pipeline import make_mesh

    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(d.type == "cuda" and d.index is not None for d in mesh.devices)


def test_mesh_frames_on_two_shards_equal_one_device(cuda, two_shards, monkeypatch):
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 1 << 20)
    rng = np.random.default_rng(51)
    data = _text(5 << 20, 52) + rng.integers(0, 256, 333333, dtype=np.uint8).tobytes()
    one, two = DeviceCompressor(cuda), DeviceCompressor(two_shards)
    mark = launches()
    got = two.compress(data)
    # 86 blocks of 64 KiB, 16 a shard: 6 shards in 3 steps, the last short
    assert launches(mark)["lz4_tokenize"] == 6
    assert got == one.compress(data)
    cut = data[: 1 << 20]
    for entropy in (True, False):
        assert two.compress_zstd(cut, 3, device_entropy=entropy) == \
            one.compress_zstd(cut, 3, device_entropy=entropy)
    blob = train_dictionary([cut[i:i + 512] for i in range(0, 8192, 512)], 2048)
    got = DeviceCompressor(two_shards, block_size=8192).compress_zstd(cut[:300000], 3, dictionary=blob)
    assert got == DeviceCompressor(cuda, block_size=8192).compress_zstd(cut[:300000], 3,
                                                                        dictionary=blob)
    assert zframe.decompress(got, dictionary=blob) == cut[:300000]


@pytest.mark.parametrize("name", list(huffman_encode_cases.cases()))
def test_sharded_huffman_encode_on_cuda(two_shards, name):
    case = huffman_encode_cases.cases()[name]
    got = getattr(huffman_torch.TorchHuffmanEncoder(two_shards), case.method)(case.items, case.tables)
    assert got == huffman_encode_cases.host_payloads(case)


@pytest.mark.parametrize("name", list(fse_encode_cases.cases()))
def test_sharded_fse_encode_on_cuda(two_shards, name):
    case = fse_encode_cases.cases()[name]
    assert fse_torch.TorchSequenceEncoder(two_shards).encode_batch(case.blocks, case.tables) == [
        zseq.encode_sequences(*b, *t) for b, t in zip(case.blocks, case.tables)]


@pytest.mark.parametrize("name", list(huffman_cases.cases()))
def test_sharded_huffman_decode_on_cuda(two_shards, name):
    case = huffman_cases.cases()[name]
    n_out = case.batch["n_out"]
    syms, final = huffman_torch.TorchHuffmanDecoder(two_shards).decode_built(case.batch, n_out)
    want, want_final = huffman_torch.TorchHuffmanDecoder("cpu").decode_built(case.batch, n_out)
    assert torch.equal(syms.cpu(), want) and np.array_equal(final, want_final)


@pytest.mark.parametrize("name", list(fse_cases.cases()))
def test_sharded_fse_decode_on_cuda(two_shards, name):
    items = fse_cases.cases()[name].items

    def run(dev):
        try:
            (lls, mls, ovs), seq_off = fse_torch.TorchSequenceDecoder(dev).decode_batch_device(items)
            return [t.cpu().tolist() for t in (lls, mls, ovs)], seq_off.tolist()
        except DecompressError as e:
            return str(e)

    assert run(two_shards) == run("cpu")


def test_mesh_extract_on_two_shards(cuda, two_shards):
    rng = np.random.default_rng(53)
    data = _text(2 << 20, 54) + rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()
    comp = native.zstd_compress(data, 3)
    assert extract.decompress_zstd_device(comp, len(data), device=cuda, mesh=two_shards) == data
    for p in np.linspace(8, len(comp) - 1, 6).astype(int).tolist():
        bad = bytearray(comp)
        bad[p] ^= 0x5A
        outcome = []
        for mesh in (None, two_shards):
            try:
                outcome.append(extract.decompress_zstd_device(bytes(bad), len(data), device=cuda,
                                                              mesh=mesh))
            except DecompressError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], p


def test_dryrun_multichip_on_two_shards_of_one_card(cuda, monkeypatch):
    from zpack_tpu_torch.parallel import multichip

    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 1 << 20)
    multichip.dryrun_multichip(2, ["cuda:0", "cuda:0"])
