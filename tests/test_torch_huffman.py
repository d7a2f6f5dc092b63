"""The port's Huffman literal-stream encoder against the JAX package's
``DeviceHuffmanEncoder`` and the host oracle ``huffman._encode_stream``, on
the CPU (the plain version).  Integer bit packing: tolerance 0."""

import numpy as np
import pytest
import torch

from test_kernels import _huff_table_pair
from zpack_tpu.codecs.zstd import encode as zenc, huffman as H
from zpack_tpu.errors import CompressError as JaxCompressError
from zpack_tpu.kernels import huffman_jax
from zpack_tpu_torch.errors import CompressError
from zpack_tpu_torch.kernels import huffman_torch

torch.set_num_threads(1)


def _stream(n: int, nsym: int, alpha: float, rng) -> np.ndarray:
    return rng.choice(np.arange(nsym, dtype=np.uint8), size=n,
                      p=rng.dirichlet(np.ones(nsym) * alpha)).astype(np.uint8)


@pytest.mark.parametrize("n", [64, 333, 1024, 5000, 65536])
def test_one_stream_matches_jax_and_oracle(n):
    rng = np.random.default_rng(n)
    data = _stream(n, 48, 0.25, rng)
    et, _ = _huff_table_pair(data.tobytes())
    got = huffman_torch.TorchHuffmanEncoder("cpu").encode_batch([data], [et])
    assert got == [H._encode_stream(data, et)]
    assert got == huffman_jax.DeviceHuffmanEncoder().encode_batch([data], [et])


def test_mixed_batch_matches_jax_and_oracle():
    """One launch, many streams with different tables and lengths."""
    rng = np.random.default_rng(7)
    streams, tables = [], []
    for i, n in enumerate([64, 700, 9000, 2048, 100]):
        data = _stream(n, 8 + 16 * i, 0.4, rng)
        streams.append(data)
        tables.append(_huff_table_pair(data.tobytes())[0])
    got = huffman_torch.TorchHuffmanEncoder("cpu").encode_batch(streams, tables)
    assert got == [H._encode_stream(s, t) for s, t in zip(streams, tables)]
    assert got == huffman_jax.DeviceHuffmanEncoder().encode_batch(streams, tables)


def test_four_stream_batch_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    blocks = [_stream(n, 30, 0.3, rng) for n in (1024, 4096, 30000)]
    tables = [_huff_table_pair(b.tobytes())[0] for b in blocks]
    blocks.append(blocks[0][:3])  # a part would be empty: no 4-stream body
    tables.append(tables[0])
    got = huffman_torch.TorchHuffmanEncoder("cpu").encode_4stream_batch(blocks, tables)
    assert got == [H.encode_4stream(b.tobytes(), t) for b, t in zip(blocks, tables)]
    assert got[-1] is None
    assert got == huffman_jax.DeviceHuffmanEncoder().encode_4stream_batch(blocks, tables)


def test_literal_sections_match_host():
    """encode_literal_sections with the port's encoder == the host path,
    including the raw, RLE and short cases."""
    rng = np.random.default_rng(9)
    prose = b"compression is the art of expectation " * 200
    cases = [
        b"",
        b"\xaa" * 500,
        b"short",
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        prose,
        prose[:700],
    ]
    host = zenc.encode_literal_sections(cases, None)
    assert zenc.encode_literal_sections(cases, huffman_torch.TorchHuffmanEncoder("cpu")) == host
    assert zenc.encode_literal_sections(cases, huffman_jax.DeviceHuffmanEncoder()) == host


def test_missing_symbol_raises():
    rng = np.random.default_rng(5)
    data = _stream(800, 16, 0.4, rng)
    et, _ = _huff_table_pair(data.tobytes())
    bad = data.copy()
    bad[17] = np.flatnonzero(et.lengths == 0)[0]  # in the table, with no code
    with pytest.raises(CompressError, match="misses"):
        huffman_torch.TorchHuffmanEncoder("cpu").encode_batch([data, bad], [et, et])
    with pytest.raises(JaxCompressError):
        huffman_jax.DeviceHuffmanEncoder().encode_batch([data, bad], [et, et])
    with pytest.raises(JaxCompressError):
        H._encode_stream(bad, et)
    bad[17] = 200  # past the table's end
    with pytest.raises(CompressError, match="misses"):
        huffman_torch.TorchHuffmanEncoder("cpu").encode_batch([bad], [et])


def test_plain_kernel_contract_against_jax_encode_streams():
    """The flat-batch plain version against ``huffman_jax.encode_streams`` on
    the padded batch of the same streams, each stream placed at the start of
    JAX's fixed row of words: the same bits and total_bits."""
    rng = np.random.default_rng(11)
    streams = [_stream(n, 40, 0.3, rng) for n in (96, 1000, 31, 2500)]
    tables = [_huff_table_pair(s.tobytes())[0] for s in streams]
    tabs = huffman_torch.pack_tables(tables)
    entries = tabs.view(np.uint16).astype(np.int32)
    counts = np.array([len(s) for s in streams])
    bits = np.array([int(t.lengths[s].astype(np.int64).sum()) for s, t in zip(streams, tables)])
    nw = huffman_jax.words_needed(max(counts))
    S = len(streams)
    rows = np.stack([np.cumsum(counts) - counts, counts, np.arange(S), bits,
                     np.arange(S) * nw], axis=1).astype(np.int64)  # JAX's fixed rows
    words, total = huffman_torch.encode_streams_plain(
        torch.from_numpy(np.concatenate(streams)), torch.from_numpy(rows),
        torch.from_numpy(tabs), n_words=S * nw)
    L = 2560
    syms = np.zeros((S, L), np.uint8)
    for i, s in enumerate(streams):
        syms[i, :len(s)] = s
    jw, jt = huffman_jax.encode_streams(syms, counts.astype(np.int32), entries & 0xFFF,
                                        entries >> 12, n_words=nw)
    assert np.array_equal(total.numpy(), np.asarray(jt))
    assert np.array_equal(total.numpy(), bits)
    assert np.array_equal(words.numpy().view(np.uint32).reshape(S, nw), np.asarray(jw))


def test_wrapper_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        huffman_torch.encode_streams(t, t, t, n_words=1)
