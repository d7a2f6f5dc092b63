"""The port's LZ4 sequence replay against the JAX package's and the host
decoder, byte for byte (tolerance 0)."""

import numpy as np
import pytest
import torch

from test_kernels import _mix
from zpack_tpu.codecs.lz4 import block as lz4block
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import lz4_jax
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import lz4_torch, replay_cases
from zpack_tpu_torch.utils.observe import launches

torch.set_num_threads(1)


def _raws():
    """The corpora of tests/test_kernels.py:test_device_lz4_sequence_replay."""
    rng = np.random.default_rng(17)
    return [
        _mix(30000, seed=51),
        b"a" * 5000 + b"bc" * 2000,          # deep RLE chains
        bytes(rng.integers(0, 256, 2000).astype(np.uint8)),  # literal-only
        (b"0123456789abcdef" * 700)[:10000],
    ]


def _replay_plain(blocks, sizes):
    batch = lz4_torch.build_batch(blocks, sizes)
    args = [torch.from_numpy(batch[k]) for k in lz4_torch.REPLAY_ARGS]
    out = lz4_torch.replay_plain(*args, n_out=batch["n_out"]).numpy()
    return [out[i, : batch["out_len"][i]].tobytes() for i in range(len(blocks))]


def _replayer(blocks, sizes):
    return lz4_torch.DeviceLZ4Replayer("cpu").decompress_blocks(blocks, sizes)


@pytest.mark.parametrize("replay", [_replay_plain, _replayer], ids=["replay_plain", "replayer"])
def test_replay_matches_jax_and_host(replay):
    raws = _raws()
    blocks = [lz4block.compress_block(r) for r in raws]
    sizes = [len(r) for r in raws]
    got = replay(blocks, sizes)
    want_jax = lz4_jax.DeviceLZ4Replayer().decompress_blocks(blocks, sizes)
    assert got == want_jax
    assert got == [lz4block.decompress_block(b, n) for b, n in zip(blocks, sizes)]
    assert got == raws


@pytest.mark.parametrize("n", [1, 13, 1000, 65536])
def test_replay_block_sizes(n):
    """One block of each size, including a literal-only tail and the full
    64 KiB bucket; the padded lanes come out zero."""
    raw = _mix(n, seed=n)
    blk = lz4block.compress_block(raw)
    batch = lz4_torch.build_batch([blk], [n])
    args = [torch.from_numpy(batch[k]) for k in lz4_torch.REPLAY_ARGS]
    out = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
    assert out.shape == (8, batch["n_out"])
    assert out[0, :n].numpy().tobytes() == raw
    assert not out[0, n:].any() and not out[1:].any()


def test_over_declared_block_raises():
    blk = lz4block.compress_block(b"x" * 1000)
    with pytest.raises(DecompressError):
        _replayer([blk], [999])


def test_offset_before_block_start_raises_where_jax_clamps():
    """``10 61 05 00 50 "bcdef"``: one literal "a", then a match at offset
    5 with only 1 byte decoded.  The host decoder and the port raise; the
    JAX replay clamps the offset and returns bytes (a documented
    divergence of the reference, pinned here)."""
    bad = bytes([0x10, 0x61, 0x05, 0x00, 0x50]) + b"bcdef"
    with pytest.raises(JaxDecompressError, match="beyond output start"):
        lz4block.decompress_block(bad, 100)
    with pytest.raises(DecompressError, match="beyond output start"):
        _replayer([bad], [100])
    assert lz4_jax.DeviceLZ4Replayer().decompress_blocks([bad], [100]) == [b"aaaaabcdef"]


@pytest.mark.parametrize("blk", [b"\x00", b"\x10a\x00", b"\x1fa\x01\x00"],
                         ids=["empty-literals", "zero-offset", "truncated-length"])
def test_parse_matches_jax_on_edges(blk):
    """The port's parse agrees with the JAX one wherever that one accepts
    or rejects (offsets before the block start aside)."""
    try:
        want = lz4_jax.parse_block_sequences(blk)
    except JaxDecompressError:
        with pytest.raises(DecompressError):
            lz4_torch.parse_block_sequences(blk)
        return
    got = lz4_torch.parse_block_sequences(blk)
    for g, w in zip(got, want):
        assert np.array_equal(g, w) if isinstance(g, np.ndarray) else g == w


_CASES = replay_cases.cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_replay_plain_matches_bytewise_on_adversarial_rows(name):
    """Copy chains, sources at chunk edges, literal-only segments, every
    row shape: ``replay_plain`` (and ``replay`` on CPU tensors) equals the
    batch executed one byte at a time, exact."""
    batch = _CASES[name]
    want = replay_cases.replay_bytewise(batch)
    args = [torch.from_numpy(batch[k]) for k in lz4_torch.REPLAY_ARGS]
    got = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(lz4_torch.replay(*args, n_out=batch["n_out"]), got)


def test_adversarial_cases_cover_what_they_name():
    """The generator keeps its promises: a row-long chain, sequence counts
    at the chunk's edges, an S that is no multiple of the chunk, rows on
    both sides of 64 KiB, padding rows, literal-only segments with offset 0
    between matches, and long matches on both sides of their offset."""
    c = _CASES
    chain = c["chain"]
    assert (chain["offset"][0, 1:3001] == 8).all() and chain["n_seq"][0] == 3001
    assert chain["out_len"][-1] == 0 and chain["n_seq"][-1] == 0
    counts = c["sequence counts 0, 1, 31, 32, 33, 70"]
    assert counts["n_seq"][:6].tolist() == [0, 1, 31, 32, 33, 70]
    assert counts["seg_start"].shape[1] % replay_cases.CHUNK
    sizes = c["rows under and over 64 KiB"]["out_len"]
    assert sizes.max() > 65536 > sizes[sizes > 0].min()
    mixed = c["literal-only segments mixed in"]
    ns = int(mixed["n_seq"][0])
    off, st = mixed["offset"][0, :ns], mixed["seg_start"][0, :ns]
    lit_only = (np.diff(st) == mixed["lit_len"][0, : ns - 1]) & (off[:-1] == 0)
    assert 100 < lit_only.sum() < ns - 100
    long = c["long matches"]
    ml = np.diff(long["seg_start"][0, : long["n_seq"][0]]) - long["lit_len"][0, : long["n_seq"][0] - 1]
    o = long["offset"][0, : long["n_seq"][0] - 1]
    assert ((ml >= 128) & (o < ml)).any() and ((ml >= 128) & (o >= ml)).any()


def test_replay_cpu_counts_no_launch():
    mark = launches()
    _replayer([lz4block.compress_block(b"abc" * 100)], [300])
    assert launches(mark)["lz4_replay"] == 0
