"""The port's LZ4 match finder against the JAX package's.

Same bytes in, same match tables out, compared exactly (tolerance 0):
``tokenize_plain`` at capj=8 against ``lz4_jax.tokenize_block_resort``
(the main path's "pair" stage), at capj=16 against the Pallas kernel run in
interpret mode, each other wire format ("u16", "hash", "scatter") against
its JAX tokenizer on the raw wire arrays, dictionary windows against the
JAX step's slicing, and ``est_plain`` against the ``_est`` formula.  The
adversarial windows of ``kernels/tokenize_cases.py`` go through the same
JAX tokenizers, and through a numpy statement of the hash chain that the
CUDA kernel walks, so that the chain is proved equal to the sort here."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_kernels import _mix
from zpack_tpu.kernels import lz4_jax, lz4_pallas
from zpack_tpu_torch.kernels import lz4_torch, tokenize_cases
from zpack_tpu_torch.utils.observe import launches

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
    mark = launches()
    for mode in lz4_torch.MODES:
        lz4_torch.tokenize(torch.zeros((1, 1024), dtype=torch.uint8), mode=mode)
    assert not any(launches(mark).values())


@pytest.mark.parametrize("bad", [
    dict(blocks=torch.zeros((1, 65537), dtype=torch.uint8)),
    dict(blocks=torch.zeros((1, 64), dtype=torch.int32)),
    dict(blocks=torch.zeros((1, 64), dtype=torch.uint8), capj=33),
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


# ---------------------------------------------------------------------------
# The adversarial windows of kernels/tokenize_cases.py
# ---------------------------------------------------------------------------

_CASES = tokenize_cases.cases()
_CASE_MODES = [(name, mode, capj) for name, case in _CASES.items()
               for mode, capj in tokenize_cases.admitted(case)]


def _jax_wire(window: np.ndarray, depth: int, mode: str, capj: int, dict_pad: int):
    """The JAX tokenizer of ``mode`` on the whole window, its outputs cut to
    the data positions as ``pipeline._step_fn.local_step`` cuts them."""
    data = jnp.asarray(window)
    if mode == "pair":
        out = lz4_jax.tokenize_block_resort(data, depth=depth, n_words=capj // 4)
    elif mode == "u16":
        out = (lz4_jax.tokenize_block_u16(data, depth=depth, n_words=capj // 4),)
    elif mode == "hash":
        out = lz4_jax.tokenize_block_noscatter(data, depth=depth, n_words=capj // 4)
    else:
        out = lz4_jax.tokenize_block(data, depth=depth)
    return [np.asarray(a)[dict_pad:] for a in out]


@pytest.mark.parametrize("name,mode,capj", [c for c in _CASE_MODES if c[1:] != ("pair", 16)])
def test_tokenize_plain_matches_jax_on_adversarial_windows(name, mode, capj):
    """Exact, on the raw wire arrays, in each mode the window admits and at
    each depth the case names ("pair" has no JAX twin at cap 16)."""
    case = _CASES[name]
    for depth in case.depths:
        want = _jax_wire(case.window, depth, mode, capj, case.dict_pad)
        got, _ = _port_wire(case.window.tobytes(), depth, capj, mode, case.dict_pad)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f"depth {depth}")


def _chain_tables(window: np.ndarray, depth: int, capj: int):
    """The match finder as a hash chain, in numpy: a stable order of the
    positions by their hash; ``prev[p]``, the position one sorted row above
    ``p``'s if its hash is equal, else ``p``; a walk of up to ``depth``
    links, nearest first, the strictly longest candidate winning; the
    end-of-window rules.  Returns ``(order, src, mlen)``: the sorted
    positions and the position-ordered tables (src -1 = none) of the whole
    window."""
    W = len(window)
    bp = np.concatenate([window, np.zeros(capj + 4, np.uint8)]).astype(np.int64)
    u = bp[:W] | (bp[1:W + 1] << 8) | (bp[2:W + 2] << 16) | (bp[3:W + 3] << 24)
    h = ((u * tokenize_cases.HASH_MUL) & 0xFFFFFFFF) >> 16
    order = np.argsort(h, kind="stable")
    prev = np.arange(W)
    same = h[order[1:]] == h[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    pos = np.arange(W)
    best_len, best_src = np.zeros(W, np.int64), np.zeros(W, np.int64)
    c, alive = pos.copy(), np.ones(W, bool)
    for _ in range(depth):
        n = prev[c]
        alive &= n != c
        c = n
        run, eq = np.zeros(W, np.int64), alive.copy()
        for k in range(capj):
            eq &= bp[pos + k] == bp[c + k]
            run += eq
        better = (run >= 4) & (run > best_len)
        best_len, best_src = np.where(better, run, best_len), np.where(better, c, best_src)
    ml = np.minimum(best_len, W - 5 - pos)
    ok = (best_len >= 4) & (pos > 0) & (pos < W - 12) & (ml >= 4)
    return order, np.where(ok, best_src, -1).astype(np.int32), np.where(ok, ml, 0).astype(np.int32)


@pytest.mark.parametrize("name,mode,capj", _CASE_MODES)
def test_tokenize_plain_matches_the_chain_formulation(name, mode, capj):
    """The sort of ``tokenize_plain`` and the chain of the CUDA kernel are
    one function: same tables in every mode, the same order in "hash"."""
    case = _CASES[name]
    d = case.dict_pad
    for depth in case.depths:
        order, src, mlen = _chain_tables(case.window, depth, capj)
        got, est = _port_wire(case.window.tobytes(), depth, capj, mode, d)
        if mode == "hash":
            np.testing.assert_array_equal(got[0], order)
        if mode == "scatter":
            tables = got
        else:
            tables = lz4_torch.from_jax_wire(mode, got)
        np.testing.assert_array_equal(tables[1], mlen[d:], err_msg=f"depth {depth}")
        np.testing.assert_array_equal(tables[0], src[d:], err_msg=f"depth {depth}")
        assert est == _est_numpy(mlen[d:])


def test_adversarial_windows_hold_what_they_name():
    """The cases are what their names say, so a later edit cannot empty them."""
    def hashes(w):
        bp = np.concatenate([w, np.zeros(4, np.uint8)]).astype(np.int64)
        u = bp[:-4] | (bp[1:-3] << 8) | (bp[2:-2] << 16) | (bp[3:-1] << 24)
        return ((u * tokenize_cases.HASH_MUL) & 0xFFFFFFFF) >> 16

    assert len(set(hashes(_CASES["zeros 65536"].window))) == 1
    assert len(set(hashes(_CASES["distinct hashes"].window))) == 4096
    for name, stretch in (("straddle 65536", 2048), ("straddle 8192", 1024)):
        h = hashes(_CASES[name].window)
        for edge in tokenize_cases.EDGE_HASHES:
            at = np.nonzero(h == edge)[0]
            assert set(at // stretch) == set(range(len(h) // stretch)), (name, edge)
    assert sorted(len(c.window) for c in _CASES.values() if not c.dict_pad)[:4] == [1, 12, 13, 4096]
    # the match at W - 13 is kept and ends at W - 5; none starts at W - 12
    w = _CASES["matches into the end rules"].window
    _, src, mlen = _chain_tables(w, 2, 8)
    assert (mlen[-13], src[-13], mlen[-12]) == (8, 127, 0)
    assert mlen[-20] == 8 and _chain_tables(w, 2, 16)[2][-20] == 15
    # every depth finds other matches in the deep bucket
    deep = _CASES["bucket longer than depth"]
    sums = [int(_chain_tables(deep.window, depth, 16)[2].sum()) for depth in deep.depths]
    assert sums == sorted(set(sums)) and (hashes(deep.window) == 0x1234).sum() >= 200


@pytest.mark.parametrize("W", [8192, 65536])
def test_mixed_batch_rows_are_independent(W):
    """Rows of every kind in one batch give what each gives alone."""
    rows = tokenize_cases.mixed_batch(W)
    assert len(rows) == len(_CASES)
    src, code = lz4_torch.tokenize(torch.from_numpy(rows), 2, 8)
    for i in range(len(rows)):
        one_src, one_code = lz4_torch.tokenize(torch.from_numpy(rows[i:i + 1]), 2, 8)
        assert torch.equal(src[i], one_src[0]) and torch.equal(code[i], one_code[0])
