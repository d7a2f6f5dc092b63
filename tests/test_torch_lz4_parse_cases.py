"""The LZ4 block parse on the blocks of
``zpack_tpu_torch/kernels/lz4_parse_cases.py``, on the CPU: the port's
plain version (``lz4_torch.build_batch``) against the JAX package's parse
and replayer and against the host decoder; a numpy statement of the CUDA
parse's two passes (the walk's two steps, the token chain and then the
values with the offset checks, a record a sequence at the bound stride;
then the tables by scans over tiles of 256) against ``build_batch`` and,
with the JAX parse's rule for an offset before the block start, against
the JAX tables; and the packing of rows into the walk's CTAs.  All
integer: tolerance 0 (exact); the errors are each side's own
``DecompressError``, message for message."""

import numpy as np
import pytest
import torch

from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import lz4_jax
from zpack_tpu_torch.codecs.lz4 import block as lz4block
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import lz4_parse_cases, lz4_torch
from zpack_tpu_torch.utils.observe import launches

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


def _ext(src: bytes, q: int, n: int):
    """A length's extension bytes from ``q``: (the sum, the next position),
    or (None, q) if the row ends inside them."""
    total = 0
    while True:
        if q >= n:
            return None, q
        c = src[q]
        q += 1
        total += c
        if c != 255:
            return total, q


def chain_np(src: bytes):
    """Step a, the walker: the token chain alone.  The token positions of
    the whole sequences, the first chain error (1 truncated literal length,
    2 literal overrun, 3 truncated offset, 6 truncated match length; 0
    none) and, for code 6, the failing token's position.  No offset is
    read: a zero or far offset does not stop the chain."""
    n = len(src)
    pos, tpos = 0, []
    while pos < n:
        t = src[pos]
        nxt = pos + 3 + (t >> 4)
        after = nxt + (t & 15 == 15)  # behind a match-length byte, if any
        if t >> 4 < 15 and after < n and not (t & 15 == 15 and src[nxt] == 255):
            tpos.append(pos)  # the common token: one step, no check of its own
            pos = after
            continue
        ll, p = t >> 4, pos + 1
        if ll == 15:
            ext, p = _ext(src, p, n)
            if ext is None:
                return tpos, 1, None
            ll += ext
        if ll > n - p:
            return tpos, 2, None
        p += ll
        if p < n:
            if n - p < 2:
                return tpos, 3, None
            p += 2
            if t & 15 == 15:
                ext, p = _ext(src, p, n)
                if ext is None:
                    return tpos, 6, pos
        tpos.append(pos)
        pos = p
    return tpos, 0, None


def values_np(src: bytes, tpos, code: int, fail_pos, clamp: bool = False):
    """Step b, the whole CTA: each sequence's ``(lit_len, offset,
    match_len, literal position)`` from its token; the output before it by
    an exclusive sum of ``lit_len + match_len`` over the whole sequences
    (the kernel's tiles of 256 with a carry give the same sums); the offset
    checks (4 zero, 5 beyond the output so far; ``clamp`` leaves 5 out, as
    the JAX parse does), on the code-6 token too.  The row's error is the
    first by sequence index, an offset error before the chain error at the
    same index.  Returns the records and ``(n_seq, literal total, out_len,
    error code)`` over the sequences before the error."""
    n, K = len(src), len(tpos)
    vals = []
    for s, p in enumerate(tpos + ([fail_pos] if code == 6 else [])):
        t = src[p]
        ll, q = t >> 4, p + 1
        if ll == 15:
            ext, q = _ext(src, q, n)
            ll += ext
        lp, q = q, q + ll
        off = ml = 0
        if q < n:
            off = src[q] | src[q + 1] << 8
            if s < K:
                ml = (t & 15) + 4 + (_ext(src, q + 2, n)[0] if t & 15 == 15 else 0)
        vals.append((ll, off, ml, lp, q < n))
    v = np.array(vals, np.int64).reshape(-1, 5)
    ll, off, ml, has_off = v[:, 0], v[:, 1], v[:, 2], v[:, 4] == 1
    whole = np.arange(len(v)) < K
    seg, lit = np.where(whole, ll + ml, 0), np.where(whole, ll, 0)
    seg_before, lit_before = np.cumsum(seg) - seg, np.cumsum(lit) - lit
    bad = np.where(has_off & (off == 0), 4,
                   np.where(has_off & (off > seg_before + ll) & (not clamp), 5, 0))
    hit = np.flatnonzero(bad)
    if hit.size:
        i = int(hit[0])
        info = (i, lit_before[i], seg_before[i], bad[i])
    else:
        info = (K, lit.sum(), seg.sum(), code)
    assert info[2] < 2**31
    return v[:K, :4].astype(np.int32), info


def walk_np(payload: bytes, offsets, clamp: bool = False):
    """Pass 1, both steps on every row: the records at row ``b``'s first
    slot ``sum(seq_bound(n_i) for i < b)`` and ``info (B, 4)``.  Each row's
    positions (and the code-6 token's) fit in its ``seq_bound`` slots."""
    lens = np.diff(offsets)
    bounds = [lz4_torch.seq_bound(int(n)) for n in lens]
    rec_off = np.concatenate([[0], np.cumsum(bounds)[:-1]]).astype(np.int64)
    rec = np.zeros((max(sum(bounds), 1), 4), np.int32)
    info = np.zeros((len(lens), 4), np.int32)
    for b, (start, n) in enumerate(zip(offsets[:-1].tolist(), lens.tolist())):
        src = payload[start:start + n]
        tpos, code, fail_pos = chain_np(src)
        assert len(tpos) + (code == 6) <= bounds[b]
        r, info[b] = values_np(src, tpos, code, fail_pos, clamp)
        rec[rec_off[b]:rec_off[b] + len(r)] = r
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


def parse_np(blocks, sizes, clamp: bool = False):
    """Both passes and the read-back between them, as the wrapper runs them
    (with ``clamp``, the JAX parse's rule: an offset before the block start
    is kept)."""
    payload = b"".join(blocks)
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.int64)
    rec, rec_off, info = walk_np(payload, offsets, clamp)
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
        # the JAX parse reads on past that offset: the row's next error, or none
        assert jerr != CLAMPED
        assert jerr == _outcome(lambda: parse_np(case.blocks, case.sizes, clamp=True))[1]
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


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_passes_in_numpy_with_the_clamp_match_jax_parse(name):
    """The numpy statement with the JAX parse's rule (an offset before the
    block start is kept, for the replay to clamp) gives the tables the JAX
    replayer builds from ``lz4_jax.parse_block_sequences``, or its error,
    on every case: the chain and the deferred checks are the JAX walk's."""
    case = CASES[name]
    got, err = _outcome(lambda: parse_np(case.blocks, case.sizes, clamp=True))
    want, jerr = _outcome(lambda: _jax_tables(case.blocks, case.sizes))
    assert err == jerr
    if err is None:
        _assert_tables_equal(got, want)


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
    mark = launches()
    got, err = _outcome(lambda: lz4_torch.parse_batch(flat, offsets, case.sizes))
    want, werr = _outcome(lambda: lz4_torch.build_batch(case.blocks, case.sizes))
    assert err == werr == case.expect
    assert launches(mark)["lz4_parse"] == 0
    if err is None:
        _assert_tables_equal({k: got[k].numpy() for k in lz4_torch.REPLAY_ARGS}
                             | {"n_out": got["n_out"]}, _tables(want))
        assert np.array_equal(got["out_len_host"], want["out_len"][:len(case.blocks)])


PACKED = ["mixed: tiny and empty rows, rows at and above the stage cap", "mixed: every block",
          "corpus blocks"]


@pytest.mark.parametrize("group", lz4_torch.PARSE_GROUPS)
@pytest.mark.parametrize("name", PACKED)
def test_parse_plan_places_every_row_once(monkeypatch, name, group):
    """Each row in one CTA of at most ``group``; a staged row's place is
    16-aligned, holds its bytes at any alignment and the walker's read
    ahead inside the stage, and no two places overlap; empty rows and rows
    above the stage cap have none (read from global memory)."""
    monkeypatch.setattr(lz4_torch, "PARSE_GROUPS", (group,))
    lens = np.array([len(b) for b in CASES[name].blocks])
    plan = lz4_torch.parse_plan(lens, lambda smem: 1, 1)
    slots, smem = plan["slots"], plan["smem"]
    rows, at = slots[..., 0], slots[..., 1]
    assert slots.shape == (-(-len(lens) // group), group, 2)
    assert sorted(rows[rows >= 0].tolist()) == list(range(len(lens)))
    n = np.where(rows >= 0, lens[np.maximum(rows, 0)], 0)
    staged = (n > 0) & (n <= lz4_torch.PARSE_STAGE_CAP)
    assert np.array_equal(at >= 0, staged) and (at[staged] % 16 == 0).all()
    assert (at + n + 32 <= smem)[staged].all()  # bytes at up to 15 in, then 18 ahead
    for g in range(len(slots)):
        places = sorted((at[g, w], n[g, w]) for w in range(group) if staged[g, w])
        assert all(a + k + 15 <= b for (a, k), (b, _) in zip(places, places[1:]))
    if group == 1:
        assert smem == 16 * ((lens[lens <= lz4_torch.PARSE_STAGE_CAP].max() + 30) // 16) + 32


def _ctas_per_sm(smem: int) -> int:
    """An H100 SM's CTAs of 256 threads with ``smem`` bytes of stage: 2,048
    threads, 232,448 bytes of shared memory, 1 KiB of it reserved a CTA,
    and the walk's static part (under 256 bytes)."""
    return min(8, 232448 // (smem + 1024 + 256))


def test_parse_plan_holds_the_main_path_in_one_wave():
    """683 rows of the main path's sizes (25.6 to 27.7 KB and one of 40.3
    KB, the native encoder's blocks of the 64 MiB corpus) on 132 SMs: one
    row a CTA fits 5 CTAs an SM, 660 walkers, and takes two waves; two rows
    a CTA, the largest beside the smallest, fit 4 and hold all 683."""
    lens = np.append(np.random.default_rng(5).integers(25_599, 27_710, 682), 40_309)
    plan = lz4_torch.parse_plan(lens, _ctas_per_sm, 132)
    assert (plan["group"], plan["ctas"], plan["per_sm"]) == (2, 342, 4)
    assert plan["waves"] == 1 and plan["resident"] == 683
    assert plan["smem"] < 2 * 28_000
    with pytest.MonkeyPatch.context() as m:
        m.setattr(lz4_torch, "PARSE_GROUPS", (1,))
        one = lz4_torch.parse_plan(lens, _ctas_per_sm, 132)
    assert (one["per_sm"], one["waves"], one["resident"]) == (5, 2, 660)


def test_parse_plan_refuses_a_group_that_does_not_fit(monkeypatch):
    """Eight rows at the stage cap need more shared memory than a CTA has:
    left to the plan, a smaller grouping is taken; with that one alone, the
    plan raises."""
    lens = np.full(8, lz4_torch.PARSE_STAGE_CAP)
    plan = lz4_torch.parse_plan(lens, _ctas_per_sm, 132)
    assert plan["group"] == 1 and plan["resident"] == 8
    monkeypatch.setattr(lz4_torch, "PARSE_GROUPS", (8,))
    with pytest.raises(ValueError):
        lz4_torch.parse_plan(lens, _ctas_per_sm, 132)
