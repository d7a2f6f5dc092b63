"""The FSE sequence decode on the adversarial batches of
``zpack_tpu_torch/kernels/fse_cases.py``, on the CPU: the port's plain
version against the JAX package's ``fse_jax.decode_seq_streams`` and, where
the stream is valid, the host oracle ``seq.decode_sequences``; and a numpy
statement of the CUDA kernel's two passes (the chain's records, then the
values read from a zero-padded word array by two-word funnel reads) against
the plain version.  All integer: tolerance 0."""

import numpy as np
import pytest
import torch

from zpack_tpu.codecs.zstd import seq as jseq
from zpack_tpu.kernels import fse_jax
from zpack_tpu_torch.kernels import fse_cases, fse_torch

torch.set_num_threads(1)

CASES = fse_cases.cases()
_LL_CONST = [b | n << 20 for b, n in zip(jseq.LL_BASELINES, jseq.LL_BITS)]
_ML_CONST = [b | n << 20 for b, n in zip(jseq.ML_BASELINES, jseq.ML_BITS)]


def _batch(case):
    return fse_torch.build_decode_batch(case.items)


def _plain(batch):
    return [t.numpy() for t in fse_torch.decode_seq_streams_plain(
        *(torch.from_numpy(batch[k]) for k in fse_torch.DECODE_ARGS))]


def _jax(case, batch):
    """``fse_jax.decode_seq_streams`` on the case, flattened as the port's
    outputs are."""
    items, B = case.items, len(case.items)
    pay = np.zeros((B, max(len(it[0]) for it in items)), np.uint8)
    tabs = np.zeros((3, B, fse_torch.TABLE), np.int32)
    for i, it in enumerate(items):
        pay[i, :len(it[0])] = np.frombuffer(it[0], np.uint8)
        for c in range(3):
            tabs[c, i] = fse_jax.pack_decode_table(it[1 + c])
    al = batch["al"].T.astype(np.int32)
    nb = np.array([it[4] for it in items], np.int32)
    out = [np.asarray(a) for a in fse_jax.decode_seq_streams(
        pay, batch["rows"][:, 2].astype(np.int32), al[0], al[1], al[2], tabs[0], tabs[1],
        tabs[2], nb, n_steps=int(nb.max()))]
    flat = [np.concatenate([o[i, :n] for i, n in enumerate(nb)]) for o in out[:3]]
    return flat + out[3:]


def walk_np(batch):
    """The CUDA kernel's decode, stated in numpy and Python integers.

    Per row: the bytes behind a zero pad of 16 bytes plus the row's offset
    in its 16-byte chunk, as 32-bit words; tables rewritten to consumed bits
    (extras + state bits) | state bits << 6 | code << 10 | next state << 16;
    the chain (thread 0) keeps a record (value position, codes) a sequence
    and reads only the state bits; then the values from the records."""
    payload, rows, seq_off, al, tables = (batch[k] for k in fse_torch.DECODE_ARGS)
    total, B = int(seq_off[-1]), len(rows)
    lls, mls, ovs = (np.zeros(total, np.int32) for _ in range(3))
    pos_f, err = np.zeros(B, np.int32), np.zeros(B, bool)
    any_steps = bool((np.diff(seq_off) > 0).any())
    for b in range(B):
        start, nbytes, bl0 = (int(x) for x in rows[b])
        s0, n = int(seq_off[b]), int(seq_off[b + 1] - seq_off[b])
        if not any_steps:
            pos_f[b] = bl0
            continue
        pad = 16 + start % 16
        stage = np.zeros(-(-(pad + nbytes + 32) // 16) * 16, np.uint8)
        stage[pad:pad + nbytes] = payload[start:start + nbytes]
        words = stage.view("<u4").tolist()

        def window(pos):
            k = max(pos + 8 * pad, 0)
            return ((words[(k >> 5) + 1] << 32 | words[k >> 5]) >> (k & 31)) & 0xFFFFFFFF

        T = []
        for c in range(3):
            for e in tables[b, c].tolist():
                sym, nb = e & 63, min(e >> 6 & 0x3FF, 15)
                extra = (_LL_CONST[min(sym, 35)] >> 20, min(sym, 30),
                         _ML_CONST[min(sym, 52)] >> 20)[c]
                T.append((nb + extra) | nb << 6 | sym << 10 | (e >> 16) << 16)
        # pass 2: the chain
        pos, state = bl0, []
        for c in range(3):  # LL, OF, ML
            pos -= int(al[b, c])
            state.append(window(pos) & ((1 << int(al[b, c])) - 1) & 511)
        rec = []
        for i in range(n):
            el, eo, em = T[state[0]], T[512 + state[1]], T[1024 + state[2]]
            code = (el >> 10 & 63) | (eo >> 10 & 63) << 6 | (em >> 10 & 63) << 12
            nl, no, nm = el >> 6 & 15, eo >> 6 & 15, em >> 6 & 15
            if i + 1 == n:  # the last sequence: no state update
                pos -= (el & 63) - nl + (eo & 63) - no + (em & 63) - nm
                rec.append((pos, code))
                break
            ps = pos - (el & 63) - (eo & 63) - (em & 63)
            rec.append((ps + nl + no + nm, code))
            w = window(ps)
            state = [((el >> 16) + (w >> (no + nm) & ((1 << nl) - 1))) & 511,
                     ((eo >> 16) + (w & ((1 << no) - 1))) & 511,
                     ((em >> 16) + (w >> no & ((1 << nm) - 1))) & 511]
            pos = ps
        pos_f[b] = pos
        # pass 3: the values
        for i, (pv, code) in enumerate(rec):
            ofc = code >> 6 & 63
            err[b] |= ofc > 30
            of_b = min(ofc, 30)
            lc, mc = _LL_CONST[min(code & 63, 35)], _ML_CONST[min(code >> 12 & 63, 52)]
            ll_b, ml_b = lc >> 20, mc >> 20
            w = window(pv) & ((1 << (ll_b + ml_b)) - 1)
            lls[s0 + i] = (lc & 0xFFFFF) + (w & ((1 << ll_b) - 1))
            mls[s0 + i] = (mc & 0xFFFFF) + (w >> ll_b)
            ovs[s0 + i] = ((1 << of_b) + (window(pv + ll_b + ml_b) & ((1 << of_b) - 1))
                           if of_b else 1)
    return [lls, mls, ovs, pos_f, err]


def _expectations_hold(case, pos_f, err):
    for i, e in enumerate(case.expect):
        assert bool(err[i]) == (e == "offset code"), (i, e)
        if e == "ok":
            assert pos_f[i] == 0, (i, e)
        elif e == "over-read":
            assert pos_f[i] < 0, (i, e)
        elif e == "unconsumed":
            assert pos_f[i] > 0, (i, e)


def test_cases_cover_what_they_name():
    modes, als, n_seq, expect = set(), set(), set(), set()
    for case in CASES.values():
        for it, sec, e in zip(case.items, case.sections, case.expect):
            als.add(tuple(t.al for t in it[1:4]))
            n_seq.add(it[4])
            expect.add(e)
            if sec is not None:
                _, p = jseq.parse_nb_sequences(sec, 0)
                modes |= {(sec[p] >> s) & 3 for s in (6, 4, 2)}
    assert modes == {0, 1, 2, 3}
    assert (0, 0, 0) in als and (9, 8, 9) in als and (6, 5, 6) in als
    assert {0, 1, 3000, 15000} <= n_seq
    assert expect == set(fse_cases.EXPECT)
    widest = max(len(it[0]) for it in CASES["above the stage cap"].items)
    assert widest > fse_torch.STAGE_CAP > min(len(it[0]) for it in CASES["above the stage cap"].items)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    case = CASES[name]
    batch = _batch(case)
    got, want = _plain(batch), _jax(case, batch)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    _expectations_hold(case, got[3], got[4])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host_oracle(name):
    case = CASES[name]
    batch = _batch(case)
    got = _plain(batch)
    off = batch["seq_off"]
    checked = 0
    for i, (it, sec) in enumerate(zip(case.items, case.sections)):
        if sec is None:
            continue
        want = jseq.decode_sequences(sec, 0, jseq.SequenceTables(*it[1:4]))
        assert want[3] == it[4]
        for c in range(3):
            assert np.array_equal(got[c][off[i]:off[i + 1]], want[c])
        checked += 1
    assert checked == sum(e == "ok" for e in case.expect) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_walk_in_numpy_matches_plain(name):
    batch = _batch(CASES[name])
    for g, w in zip(walk_np(batch), _plain(batch)):
        assert np.array_equal(g, w)


def test_kernel_walk_in_numpy_on_a_batch_with_no_sequence():
    """No block has a sequence: nothing is read, ``pos_f`` is the sentinel's
    position (the plain version's rule), at any alignment of the rows."""
    item = CASES["predefined"].items[0]
    for lead in (0, 5):
        items = [(b"\x00" * lead + item[0], *item[1:4], 0), (item[0], *item[1:4], 0)]
        batch = _batch(fse_cases.Case(items, [None, None], ["empty", "empty"]))
        got, want = walk_np(batch), _plain(batch)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert np.array_equal(want[3], batch["rows"][:, 2])
