"""The FSE sequence encode on the batches of
``zpack_tpu_torch/kernels/fse_encode_cases.py``, on the CPU: the port's
plain version against the JAX package's ``fse_jax.DeviceSequenceEncoder``
and the host oracle ``seq.encode_sequences``; and a numpy statement of the
CUDA kernel's two steps (the state walk, one machine a lane on tables times
4, storing the state each step starts from; then, in tiles of 256 sequences, the
widths, the exclusive scan and the packing into words with the partial last
word carried, the flush and the sentinel) against the plain version.  All
integer: tolerance 0."""

import functools

import numpy as np
import pytest
import torch

from zpack_tpu.codecs.zstd import seq as jseq
from zpack_tpu.kernels import fse_jax
from zpack_tpu_torch.kernels import fse_encode_cases, fse_torch

torch.set_num_threads(1)

CASES = fse_encode_cases.cases()
_TABLE, _NSYM = fse_torch.TABLE, fse_torch.NSYM
_XBITS = (np.array(jseq.LL_BITS + [0] * (64 - len(jseq.LL_BITS))),
          np.array(jseq.ML_BITS + [0] * (64 - len(jseq.ML_BITS))))
_SHIFT = (0, 16, 8)  # the code of LL, OF, ML in a code word


@functools.lru_cache(maxsize=None)
def _batch(name):
    case = CASES[name]
    return fse_torch.build_batch(case.blocks, case.tables)


@functools.lru_cache(maxsize=None)
def _plain(name):
    batch = _batch(name)
    words, total = fse_torch.encode_seq_streams_plain(
        *(torch.from_numpy(batch[k]) for k in fse_torch.BATCH_ARGS), n_words=batch["n_words"])
    return words.numpy(), total.numpy()


def _port_bytes(name):
    case = CASES[name]
    return fse_torch.TorchSequenceEncoder("cpu").encode_batch(case.blocks, case.tables)


def _split(tables_b):
    """(st, dnb, dfs) of one block's packed tables, each (3, ...) int64."""
    t = tables_b.astype(np.int64)
    return t[:, :_TABLE], t[:, _TABLE:_TABLE + _NSYM], t[:, _TABLE + _NSYM:]


def walk_np(batch):
    """Step 1 (lanes 0, 1, 2 of warp 0 of each CTA, one machine each): the
    state chains on the tables times 4 (a table index is then a byte offset,
    masked by 511 * 4).  Returns the states each step k >= 1 starts from,
    (3, total) times 4 (row 0 of each block unused), and the states after
    the last step, (B, 3)."""
    fields, seq_off, tables = batch["fields"], batch["seq_off"], batch["tables"]
    codes = fields[:, 0].astype(np.int64)
    states = np.zeros((3, len(codes)), np.int64)
    B = len(seq_off) - 1
    fin = np.zeros((B, 3), np.int64)
    for b in range(B):
        s0, n = int(seq_off[b]), int(seq_off[b + 1] - seq_off[b])
        if n == 0:
            continue
        st, dnb, dfs = (x.tolist() for x in _split(tables[b]))
        for m in range(3):
            c = [x >> _SHIFT[m] & 63 for x in codes[s0:s0 + n].tolist()]
            nb = (dnb[m][c[0]] + (1 << 15)) >> 16  # fse.EncodeTable.init_state
            s = 4 * st[m][((((nb << 16) - dnb[m][c[0]]) >> nb) + dfs[m][c[0]]) & 511]
            for k in range(1, n):
                states[m, s0 + k] = s
                nb = (s + 4 * dnb[m][c[k]]) >> 18
                s = 4 * st[m][(((s >> nb) + 4 * dfs[m][c[k]]) & (511 * 4)) // 4]
            fin[b, m] = s >> 2
    return states, fin


def pack_np(batch, states, fin, tile: int = fse_encode_cases.TILE):
    """Step 2 (the CTA): per tile of ``tile`` rows, each row's state widths
    from its stored states (times 4) and codes, its extra-bit widths, an exclusive scan
    of the bits, the fields OR'ed into the tile's words; the whole words
    stored, the partial last one carried into the next tile; then the flush
    (ml, of, ll at their accuracy logs) and the sentinel."""
    fields, seq_off, tables, al, word_off = (batch[k] for k in fse_torch.BATCH_ARGS)
    words = np.zeros(batch["n_words"], np.uint64)
    B = len(seq_off) - 1
    total = np.zeros(B, np.int64)
    for b in range(B):
        s0, n = int(seq_off[b]), int(seq_off[b + 1] - seq_off[b])
        base, nw = int(word_off[b]), int(word_off[b + 1] - word_off[b])
        _, dnb, _ = _split(tables[b])

        def store(w0, tile_bits, count):
            for j in range(count):
                if w0 + j < nw:
                    words[base + w0 + j] = tile_bits >> (32 * j) & 0xFFFFFFFF

        run, carry = 0, 0
        for t0 in range(0, n, tile):
            r = fields[s0 + t0:s0 + min(t0 + tile, n)].astype(np.int64)
            c = r[:, 0]
            k = np.arange(t0, t0 + len(r))
            state = [states[m, s0 + k] >> 2 for m in range(3)]
            sn = [np.where(k > 0, np.clip((states[m, s0 + k] + 4 * dnb[m][c >> _SHIFT[m] & 63])
                                          >> 18, 0, 32), 0) for m in range(3)]
            xn = [_XBITS[0][c & 63], _XBITS[1][c >> 8 & 63], np.minimum(c >> 16 & 63, 32)]
            items = [(state[1], sn[1]), (state[2], sn[2]), (state[0], sn[0]),
                     (r[:, 1], xn[0]), (r[:, 2], xn[1]), (r[:, 3], xn[2])]
            bits = sum(nb for _, nb in items)
            excl = np.cumsum(bits) - bits
            w0 = run >> 5
            acc = carry
            for i in range(len(r)):
                p = run - 32 * w0 + int(excl[i])
                for v, nb in items:
                    acc |= (int(v[i]) & ((1 << int(nb[i])) - 1)) << p
                    p += int(nb[i])
            end = run + int(bits.sum())
            whole = (end >> 5) - w0
            store(w0, acc, whole)
            carry, run = acc >> (32 * whole), end
        w0 = run >> 5
        p = run - 32 * w0
        if n:
            for m in (2, 1, 0):
                carry |= (int(fin[b, m]) & ((1 << int(al[b, m])) - 1)) << p
                p += int(al[b, m])
            carry |= 1 << p
            store(w0, carry, (32 * w0 + p + 1 + 31 >> 5) - w0)
        total[b] = 32 * w0 + p
    return words.astype(np.uint32).view(np.int32), total.astype(np.int32)


def test_cases_cover_what_they_name():
    kinds, als, ns, shared = set(), set(), set(), 0
    of31 = ll16 = ml16 = False
    for case in CASES.values():
        seen = set()
        for block, tabs in zip(case.blocks, case.tables):
            ns.add(len(block[0]))
            for t in tabs:
                kinds.add(type(t).__name__ if t.al else "rle")
            als.add(tuple(t.al for t in tabs))
            shared += any(id(t) in seen for t in tabs)
            seen |= {id(t) for t in tabs if t.al}
            of31 |= bool((fse_torch.of_codes_np(block[2]) == 31).any())
            ll16 |= bool((fse_torch.ll_codes_np(block[0]) == 35).any())
            ml16 |= bool((fse_torch.ml_codes_np(block[1]) == 52).any())
    assert kinds == {"EncodeTable", "rle"} and shared > 0  # repeat mode
    assert (9, 8, 9) in als and (6, 5, 6) in als and (0, 0, 0) in als
    assert of31 and ll16 and ml16
    tile = fse_encode_cases.TILE
    assert {1, 2, tile - 1, tile, tile + 1, 2 * tile + 1} <= ns
    assert max(ns) > fse_torch.ENCODE_STAGE_CAP
    assert len(CASES["tiny blocks beside a long one"].blocks) == 301
    ends = CASES["ends on a word"]
    assert [fse_encode_cases.total_bits(b, t) % 32 for b, t in zip(ends.blocks, ends.tables)] \
        == [0, 31, 0]
    assert [name for name, c in CASES.items() if not c.fits_jax] == ["beyond the JAX word buffer"]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host_oracle(name):
    case = CASES[name]
    assert _port_bytes(name) == [jseq.encode_sequences(*b, *t)
                                 for b, t in zip(case.blocks, case.tables)]
    # each block's words are sized by the bound of every state write at
    # its accuracy log; the bits never reach past it
    assert (_plain(name)[1] + 1 <= _batch(name)["ub_bits"]).all()


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.fits_jax])
def test_plain_matches_jax(name):
    case = CASES[name]
    assert _port_bytes(name) == fse_jax.DeviceSequenceEncoder().encode_batch(case.blocks,
                                                                            case.tables)


def test_jax_word_buffer_drops_what_the_port_keeps():
    """About 78 bits a sequence overflow the JAX encoder's 64 a sequence:
    its words drop the overflow; the port sizes each block by the section
    header's bound and equals the host oracle."""
    case = CASES["beyond the JAX word buffer"]
    want = [jseq.encode_sequences(*b, *t) for b, t in zip(case.blocks, case.tables)]
    assert fse_encode_cases.total_bits(case.blocks[0], case.tables[0]) > 64 * 64 + 64
    assert fse_jax.DeviceSequenceEncoder().encode_batch(case.blocks, case.tables) != want
    assert _port_bytes("beyond the JAX word buffer") == want


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_steps_in_numpy_match_plain(name):
    batch = _batch(name)
    words, total = pack_np(batch, *walk_np(batch))
    want_words, want_total = _plain(name)
    assert np.array_equal(total, want_total)
    assert np.array_equal(words, want_words)
