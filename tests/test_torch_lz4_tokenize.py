"""The port's LZ4 match finder against the JAX package's.

Same bytes in, same match tables out, compared exactly (tolerance 0):
``tokenize_plain`` at capj=8 against ``lz4_jax.tokenize_block_resort``
(the main path's "pair" stage), at capj=16 against the Pallas kernel run in
interpret mode, each other wire format ("u16", "hash", "scatter") against
its JAX tokenizer on the raw wire arrays, dictionary windows against the
JAX step's slicing, and ``est_plain`` against the ``_est`` formula."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_kernels import _mix
from zpack_tpu.kernels import lz4_jax, lz4_pallas
from zpack_tpu_torch.kernels import lz4_torch

torch.set_num_threads(1)


def _corpus(kind: str, n: int) -> bytes:
    """The corpora of tests/test_kernels.py, plus real noise and a ragged
    block (five eighths of real bytes, zero-padded as the pipeline pads)."""
    if kind == "ragged":
        return _mix(n * 5 // 8 - 123, seed=n + 1).ljust(n, b"\0")
    return {
        "mix": lambda: _mix(n, seed=n),
        "rand": lambda: bytes(random.Random(1).getrandbits(8) for _ in range(n)),
        "zeros": lambda: b"\0" * n,
        "text": lambda: (b"orbit doubling parse on tpu! " * (n // 29 + 1))[:n],
        "noise": lambda: np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes(),
    }[kind]()


def _port_tables(data: bytes, depth: int, capj: int):
    blocks = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None]
    src, code = lz4_torch.tokenize(blocks, depth, capj)
    return lz4_torch.from_jax_wire("pair", (src.numpy()[0], code.numpy()[0]))


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("kind", ["mix", "rand", "zeros", "text", "noise"])
def test_tokenize_plain_matches_jax_pair(kind, n, depth):
    data = _corpus(kind, n)
    src16, code = lz4_jax.tokenize_block_resort(
        jnp.asarray(np.frombuffer(data, np.uint8)), depth=depth, n_words=2)
    want = lz4_torch.from_jax_wire("pair", (np.asarray(src16), np.asarray(code)))
    _assert_tables_equal(_port_tables(data, depth, 8), want)


def test_tokenize_plain_capj16_matches_pallas_interpret():
    """The Pallas kernel's own contract (cap 16, hash-ordered output),
    one 64 KiB block in interpret mode (about 12 s on a CPU)."""
    data = (_mix(30000, seed=3) + b"the quick brown fox " * 2000)[:65536]
    pos, packed = lz4_pallas.tokenize_blocks_device(
        jnp.asarray(np.frombuffer(data, np.uint8)[None]), depth=2, interpret=True)
    want = lz4_torch.from_jax_wire("hash", (np.asarray(pos)[0], np.asarray(packed)[0]))
    assert (want[1] == 16).any()  # the cap is reached, so 16 vs 8 matters
    _assert_tables_equal(_port_tables(data, 2, 16), want)


@pytest.mark.parametrize("kind", ["mix", "rand", "zeros", "text"])
def test_from_jax_wire_u16_matches_port(kind):
    data = _corpus(kind, 8192)
    tok = lz4_jax.tokenize_block_u16(
        jnp.asarray(np.frombuffer(data, np.uint8)), depth=2, n_words=2)
    _assert_tables_equal(_port_tables(data, 2, 8),
                         lz4_torch.from_jax_wire("u16", (np.asarray(tok),)))


WIRE_KINDS = ["mix", "rand", "zeros", "text", "ragged"]


def _jnp(data: bytes):
    return jnp.asarray(np.frombuffer(data, np.uint8))


def _port_wire(data: bytes, depth: int, capj: int, mode: str, dict_pad: int = 0):
    blocks = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None]
    arrays, est = lz4_torch.tokenize_est(blocks, depth, capj, mode, dict_pad)
    return [a.numpy()[0] for a in arrays], int(est[0])


def _est_numpy(mlen: np.ndarray) -> int:
    """``_est`` of ``pipeline._step_fn`` over rows of B data positions."""
    mlen = np.asarray(mlen, np.int64).reshape(-1, mlen.shape[-1])
    hit = mlen >= 4
    return int((mlen.shape[1] - np.where(hit, mlen, 0).sum(1) + 3 * hit.sum(1)).sum())


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("kind", WIRE_KINDS)
def test_tokenize_plain_u16_matches_jax_wire(kind, depth):
    data = _corpus(kind, 8192)
    tok = np.asarray(lz4_jax.tokenize_block_u16(_jnp(data), depth=depth, n_words=2))
    (got,), est = _port_wire(data, depth, 8, "u16")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, tok)
    assert est == _est_numpy(lz4_jax.unpack_u16_host(tok)[1])


@pytest.mark.parametrize("n_words", [2, 4])
@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("kind", WIRE_KINDS)
def test_tokenize_plain_hash_matches_jax_noscatter_wire(kind, depth, n_words):
    """The raw ``(pos, packed)`` arrays, the 0x1FFFF of a missing src
    included, not only the unpacked tables."""
    data = _corpus(kind, 16384)
    pos, packed = lz4_jax.tokenize_block_noscatter(_jnp(data), depth=depth, n_words=n_words)
    (got_pos, got_packed), est = _port_wire(data, depth, 4 * n_words, "hash")
    assert got_pos.dtype == got_packed.dtype == np.int32
    np.testing.assert_array_equal(got_pos, np.asarray(pos))
    np.testing.assert_array_equal(got_packed, np.asarray(packed))
    src, mlen = lz4_pallas.unsort_host(np.asarray(pos), np.asarray(packed))
    _assert_tables_equal(lz4_torch.from_jax_wire("hash", (got_pos, got_packed)), (src, mlen))
    assert est == _est_numpy(mlen)


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("kind", WIRE_KINDS)
def test_tokenize_plain_scatter_matches_jax_tokenize_block(kind, depth):
    data = _corpus(kind, 16384)
    src, mlen = lz4_jax.tokenize_block(_jnp(data), depth=depth)
    (got_src, got_mlen), est = _port_wire(data, depth, 16, "scatter")
    assert got_src.dtype == got_mlen.dtype == np.int32
    np.testing.assert_array_equal(got_src, np.asarray(src))
    np.testing.assert_array_equal(got_mlen, np.asarray(mlen))
    assert est == _est_numpy(np.asarray(mlen))


@pytest.mark.parametrize("mode,B", [("u16", 4096), ("pair", 8192)])
@pytest.mark.parametrize("kind", ["mix", "text", "ragged"])
def test_tokenize_plain_dictionary_window_matches_jax_step(kind, mode, B):
    """The window is dictionary then block; the end-of-block rules apply at
    the end of the window, the outputs keep the data positions only, and
    ``src`` stays relative to the window start, as in ``local_step``."""
    d = 2048
    window = _corpus("mix", d) + _corpus(kind, B)
    if mode == "u16":
        want = [np.asarray(lz4_jax.tokenize_block_u16(_jnp(window), depth=2, n_words=2))[d:]]
        mlen = lz4_jax.unpack_u16_host(want[0])[1]
    else:
        want = [np.asarray(a)[d:] for a in
                lz4_jax.tokenize_block_resort(_jnp(window), depth=2, n_words=2)]
        mlen = lz4_jax.unpack_resort_host(*want)[1]
    got, est = _port_wire(window, 2, 8, mode, dict_pad=d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (B,)
        np.testing.assert_array_equal(g, w)
    src = lz4_torch.from_jax_wire(mode, got)[0]
    assert ((src >= 0) & (src < d)).any()  # some matches reach into the dictionary
    assert est == _est_numpy(mlen)


def test_est_plain_counts_rows_given_in_every_mode():
    """One estimate whatever the wire format at one cap, and row sums add."""
    datas = [_corpus(k, 4096) for k in ("mix", "text", "zeros")]
    blocks = torch.from_numpy(np.stack([np.frombuffer(d, np.uint8) for d in datas]))
    ests = {m: int(lz4_torch.tokenize_est(blocks, 2, 8, m)[1][0])
            for m in ("pair", "u16", "hash", "scatter")}
    assert len(set(ests.values())) == 1
    assert ests["pair"] == sum(int(lz4_torch.tokenize_est(blocks[i:i + 1], 2, 8)[1][0])
                               for i in range(3))
    assert int(lz4_torch.tokenize_est(blocks[2:], 2, 8)[1][0]) < 0  # zeros: overlapping matches


def test_tokenize_batch_rows_are_independent():
    """A batch gives each row what that row gives alone."""
    datas = [_corpus(k, 4096) for k in ("mix", "text", "noise", "zeros")]
    blocks = torch.from_numpy(np.stack([np.frombuffer(d, np.uint8) for d in datas]))
    src, code = lz4_torch.tokenize(blocks, 2, 8)
    for i, d in enumerate(datas):
        one_src, one_code = lz4_torch.tokenize(blocks[i : i + 1], 2, 8)
        assert torch.equal(src[i], one_src[0]) and torch.equal(code[i], one_code[0])


def test_tokenize_cpu_takes_plain_and_counts_no_launch():
    lz4_torch.reset_launches()
    for mode in lz4_torch.MODES:
        lz4_torch.tokenize(torch.zeros((1, 1024), dtype=torch.uint8), mode=mode)
    assert not any(lz4_torch.LAUNCHES.values())


@pytest.mark.parametrize("bad", [
    dict(blocks=torch.zeros((1, 65537), dtype=torch.uint8)),
    dict(blocks=torch.zeros((1, 64), dtype=torch.int32)),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), capj=17),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), depth=0),
    dict(blocks=torch.zeros((1, 8193), dtype=torch.uint8), mode="u16"),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), mode="u16", capj=12),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), mode="hash", dict_pad=8),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), mode="pair", dict_pad=64),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), mode="sorted"),
], ids=["window", "dtype", "capj", "depth", "u16-window", "u16-capj",
        "hash-dict", "dict-pad", "mode"])
def test_tokenize_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        lz4_torch.tokenize(**bad)
