"""The LZ4 block parse on the blocks of
``zpack_tpu_torch/kernels/lz4_parse_cases.py``, on the CPU: the port's
plain version (``lz4_torch.build_batch``) against the JAX package's parse
and replayer and against the host decoder; and a numpy statement of the
CUDA parse's two passes (a record a sequence at the bound stride, then the
tables by scans over tiles of 256) against ``build_batch``.  All integer:
tolerance 0; the errors are each side's own ``DecompressError``, message
for message."""

import numpy as np
import pytest
import torch

from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import lz4_jax
from zpack_tpu_torch.codecs.lz4 import block as lz4block
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import lz4_parse_cases, lz4_torch

torch.set_num_threads(1)

CASES = lz4_parse_cases.cases()
VALID = [k for k, c in CASES.items() if c.expect is None]
#: the JAX replay clamps an offset before the block start (ROADMAP Queue 3)
CLAMPED = "match offset beyond output start"
TILE = 256  # records a tile of the layout pass (kLayoutThreads)


def _outcome(fn):
    """``(result, None)`` or ``(None, message)`` of either package's error."""
    try:
        return fn(), None
    except (DecompressError, JaxDecompressError) as e:
        return None, str(e)


def _tables(batch):
    return {k: batch[k] for k in lz4_torch.REPLAY_ARGS} | {"n_out": batch["n_out"]}


def _assert_tables_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def _jax_tables(blocks, sizes):
    """The padded batch ``lz4_jax.DeviceLZ4Replayer.decompress_blocks``
    builds, from the JAX package's own parse."""
    parsed = [lz4_jax.parse_block_sequences(b) for b in blocks]
    bucket = lz4_jax.DeviceLZ4Replayer._bucket
    bp = 8
    while bp < len(blocks):
        bp <<= 1
    S = bucket(max(len(p[0]) for p in parsed), (64, 256, 1024, 4096, 16384))
    L = bucket(max(len(p[3]) for p in parsed), lz4_jax.DeviceLZ4Replayer.BUCKETS)
    t = {"lit_bytes": np.zeros((bp, L), np.uint8),
         **{k: np.zeros((bp, S), np.int32)
            for k in ("seg_start", "lit_start", "lit_len", "offset")},
         "n_seq": np.zeros(bp, np.int32), "out_len": np.zeros(bp, np.int32)}
    for i, (lls, offs, mls, lits) in enumerate(parsed):
        k = len(lls)
        seg = lls + mls
        if int(seg.sum()) > sizes[i]:
            raise JaxDecompressError("block output exceeds declared size")
        t["seg_start"][i, :k] = np.cumsum(seg) - seg
        t["lit_start"][i, :k] = np.cumsum(lls) - lls
        t["lit_len"][i, :k], t["offset"][i, :k] = lls, offs
        t["n_seq"][i], t["out_len"][i] = k, seg.sum()
        t["lit_bytes"][i, :len(lits)] = np.frombuffer(lits, np.uint8)
    t["n_out"] = bucket(max(int(t["out_len"].max()), 1), lz4_jax.DeviceLZ4Replayer.BUCKETS)
    return t


# ---------------------------------------------------------------------------
# The CUDA parse, stated in numpy and Python integers
# ---------------------------------------------------------------------------


def walk_np(payload: bytes, offsets):
    """Pass 1: each row walked token by token (thread 0's loop, the checks
    of ``parse_block_sequences`` in its order, int32 lengths), one record
    ``(lit_len, offset, match_len, literal position)`` a sequence at row
    ``b``'s offset ``sum(seq_bound(n_i) for i < b)``; per row ``(n_seq,
    literal total, out_len, error code)``."""
    lens = np.diff(offsets)
    bounds = [lz4_torch.seq_bound(int(n)) for n in lens]
    rec_off = np.concatenate([[0], np.cumsum(bounds)[:-1]]).astype(np.int64)
    rec = np.zeros((max(sum(bounds), 1), 4), np.int32)
    info = np.zeros((len(lens), 4), np.int32)
    for b, (start, n) in enumerate(zip(offsets[:-1].tolist(), lens.tolist())):
        src = payload[start:start + n]
        pos = out_len = lits = k = err = 0
        while pos < n:
            token = src[pos]
            pos += 1
            ll = token >> 4
            if ll == 15:
                while True:
                    if pos >= n:
                        err = 1
                        break
                    c = src[pos]
                    pos += 1
                    ll += c
                    if c != 255:
                        break
                if err:
                    break
            if ll > n - pos:
                err = 2
                break
            lp = pos
            pos += ll
            out_len += ll
            lits += ll
            if pos == n:
                rec[rec_off[b] + k] = (ll, 0, 0, lp)
                k += 1
                break
            if n - pos < 2:
                err = 3
                break
            off = src[pos] | src[pos + 1] << 8
            pos += 2
            if off == 0:
                err = 4
                break
            if off > out_len:
                err = 5
                break
            ml = (token & 15) + 4
            if token & 15 == 15:
                while True:
                    if pos >= n:
                        err = 6
                        break
                    c = src[pos]
                    pos += 1
                    ml += c
                    if c != 255:
                        break
                if err:
                    break
            out_len += ml
            rec[rec_off[b] + k] = (ll, off, ml, lp)
            k += 1
        assert k <= bounds[b] and out_len < 2**31
        info[b] = (k, lits, out_len, err)
    return rec, rec_off, info


def layout_np(payload: bytes, offsets, rec, rec_off, info, bp, S, L):
    """Pass 2: per row, tiles of 256 records; exclusive scans of
    ``lit_len + match_len`` and ``lit_len`` with a carry from tile to tile;
    the tile's literal bytes copied a byte at a time, each from the run
    whose start is the last at or before it; zeros elsewhere."""
    arr = np.frombuffer(payload, np.uint8)
    t = {"lit_bytes": np.zeros((bp, L), np.uint8),
         **{k: np.zeros((bp, S), np.int32)
            for k in ("seg_start", "lit_start", "lit_len", "offset")},
         "n_seq": np.zeros(bp, np.int32), "out_len": np.zeros(bp, np.int32)}
    for b in range(len(info)):
        n = int(info[b, 0])
        r = rec[rec_off[b]:rec_off[b] + n].astype(np.int64)
        carry_seg = carry_lit = 0
        for c0 in range(0, n, TILE):
            q = r[c0:c0 + TILE]
            seg, ll = q[:, 0] + q[:, 2], q[:, 0]
            es, el = np.cumsum(seg) - seg, np.cumsum(ll) - ll
            ls = carry_lit + el
            t["seg_start"][b, c0:c0 + len(q)] = carry_seg + es
            t["lit_start"][b, c0:c0 + len(q)] = ls
            t["lit_len"][b, c0:c0 + len(q)] = q[:, 0]
            t["offset"][b, c0:c0 + len(q)] = q[:, 1]
            j = np.arange(carry_lit, carry_lit + int(ll.sum()))
            run = np.searchsorted(ls, j, side="right") - 1
            t["lit_bytes"][b, j] = arr[offsets[b] + j + (q[run, 3] - ls[run])]
            carry_seg += int(seg.sum())
            carry_lit += int(ll.sum())
        t["n_seq"][b], t["out_len"][b] = n, info[b, 2]
    return t


def parse_np(blocks, sizes):
    """Both passes and the read-back between them, as the wrapper runs them."""
    payload = b"".join(blocks)
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.int64)
    rec, rec_off, info = walk_np(payload, offsets)
    bad = np.flatnonzero(info[:, 3])
    if bad.size:
        raise DecompressError(lz4_torch.PARSE_ERRORS[info[bad[0], 3] - 1])
    if (info[:, 2] > np.asarray(sizes)).any():
        raise DecompressError("block output exceeds declared size")
    bp, S, L, n_out = lz4_torch._batch_shape(info[:, 0], info[:, 1], info[:, 2])
    return layout_np(payload, offsets, rec, rec_off, info, bp, S, L) | {"n_out": n_out}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_cases_cover_what_they_name():
    """Every length edge occurs as a literal and as a match length, runs of
    65,535, a row at the sequence-count bound, a row above the stage cap,
    every error message, and mixed batches of all of them."""
    seen_ll, seen_ml = set(), set()
    for k in VALID:
        b = lz4_torch.build_batch(CASES[k].blocks, CASES[k].sizes)
        for i, ns in enumerate(b["n_seq"]):
            seen_ll |= set(b["lit_len"][i, :ns].tolist())
            nxt = np.append(b["seg_start"][i, 1:ns], b["out_len"][i])
            seen_ml |= set((nxt - b["seg_start"][i, :ns] - b["lit_len"][i, :ns]).tolist())
    edges = set(lz4_parse_cases.EDGES)
    assert edges | {65535} <= seen_ll
    assert edges | {e + 4 for e in edges} | {65535, 65539} <= seen_ml
    at = CASES["sequences at the count bound"]
    b = lz4_torch.build_batch(at.blocks, at.sizes)
    assert b["n_seq"][:4].tolist() == [lz4_torch.seq_bound(len(x)) for x in at.blocks]
    assert max(map(len, CASES["a row above the stage cap"].blocks)) > lz4_torch.PARSE_STAGE_CAP
    assert {c.expect for c in CASES.values()} == {None, "block output exceeds declared size",
                                                  *lz4_torch.PARSE_ERRORS}
    mixed = CASES["mixed: every block"].blocks
    assert all(b in mixed for c in CASES.values() for b in c.blocks)


@pytest.mark.parametrize("name", list(CASES))
def test_build_batch_matches_jax_parse(name):
    """``build_batch``'s tables equal the ones the JAX replayer builds from
    its own parse, or both raise the same message; an offset before the
    block start raises in the port only (the JAX replay clamps it)."""
    case = CASES[name]
    got, err = _outcome(lambda: lz4_torch.build_batch(case.blocks, case.sizes))
    want, jerr = _outcome(lambda: _jax_tables(case.blocks, case.sizes))
    assert err == case.expect
    if case.expect == CLAMPED:
        assert jerr is None
        return
    assert jerr == err
    if err is None:
        _assert_tables_equal(_tables(got), want)


@pytest.mark.parametrize("name", [k for k in VALID if not k.startswith("mixed")] + [
    "block over its declared size", "parse error later beside a size error earlier",
    "truncated match length (2)", "mixed: every block"])
def test_replayer_bytes_match_jax_replayer(name):
    """The port's replayer on the CPU and the JAX one, through its own CPU
    route: the same bytes, or the same error message."""
    case = CASES[name]
    got, err = _outcome(lambda: lz4_torch.DeviceLZ4Replayer("cpu").decompress_blocks(
        case.blocks, case.sizes))
    want, jerr = _outcome(lambda: lz4_jax.DeviceLZ4Replayer().decompress_blocks(
        case.blocks, case.sizes))
    assert (err, jerr) == (case.expect, case.expect)
    assert got == want


@pytest.mark.parametrize("name", [k for k in VALID if not k.startswith("mixed")])
def test_replayer_bytes_match_host_decoder(name):
    """Each block of a valid batch decodes to the same bytes through the
    host decoder's Python walk and its native route."""
    case = CASES[name]
    got = lz4_torch.DeviceLZ4Replayer("cpu").decompress_blocks(case.blocks, case.sizes)
    assert got == [lz4block.decompress_block(b) for b in case.blocks]
    assert got == [lz4block.decompress_block(b, n) for b, n in zip(case.blocks, case.sizes)]


@pytest.mark.parametrize("msg", list(lz4_parse_cases.BAD))
def test_bad_blocks_raise_the_host_decoders_message(msg):
    """Each malformed block raises the same message in the host decoder's
    walk as in the port's parse."""
    for blk in lz4_parse_cases.BAD[msg]:
        with pytest.raises(DecompressError, match=msg):
            lz4block.decompress_block(blk)
        with pytest.raises(DecompressError, match=msg):
            lz4_torch.parse_block_sequences(blk)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_passes_in_numpy_match_build_batch(name):
    """The CUDA parse's two passes, in numpy, equal ``build_batch`` exactly
    (every table, every padding lane) and raise the same first error."""
    case = CASES[name]
    got, err = _outcome(lambda: parse_np(case.blocks, case.sizes))
    want, werr = _outcome(lambda: lz4_torch.build_batch(case.blocks, case.sizes))
    assert err == werr == case.expect
    if err is None:
        _assert_tables_equal(got, _tables(want))


def test_sequence_count_never_exceeds_the_bound():
    """The records' stride: on every row of every case, the sequences (and
    the records written before an error) fit in ``seq_bound``, and the
    bound is reached."""
    blocks = CASES["mixed: every block"].blocks
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.int64)
    _, _, info = walk_np(b"".join(blocks), offsets)
    bounds = np.array([lz4_torch.seq_bound(len(b)) for b in blocks])
    assert (info[:, 0] <= bounds).all()
    assert (info[:, 0] == bounds).sum() >= 4


@pytest.mark.parametrize("name", ["corpus blocks", "parse error later beside a size error earlier",
                                  "block over its declared size"])
def test_parse_batch_on_cpu_is_build_batch(name):
    """The wrapper on CPU tensors takes the plain version: the same tables
    as tensors, the same error, and no launch counted."""
    case = CASES[name]
    flat, offsets = lz4_torch.pack_blocks(case.blocks)
    assert bytes(flat.numpy()) == b"".join(case.blocks)
    lz4_torch.reset_launches()
    got, err = _outcome(lambda: lz4_torch.parse_batch(flat, offsets, case.sizes))
    want, werr = _outcome(lambda: lz4_torch.build_batch(case.blocks, case.sizes))
    assert err == werr == case.expect
    assert lz4_torch.LAUNCHES["lz4_parse"] == 0
    if err is None:
        _assert_tables_equal({k: got[k].numpy() for k in lz4_torch.REPLAY_ARGS}
                             | {"n_out": got["n_out"]}, _tables(want))
        assert np.array_equal(got["out_len_host"], want["out_len"][:len(case.blocks)])
