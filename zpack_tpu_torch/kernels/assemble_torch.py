"""The zstd frame assembly on a torch device: repeat-offset stitching,
segment layout, the layout checks and the output's trim.

Written for the card, with no TPU original: the JAX package lays the
sequences out with XLA ops (``extract._scatter_rows``, ``_masked_sums``,
``_seg_prefix_validate``) and stitches the repeat offsets on the host.  Here
the three steps run in ``csrc/zstd_assemble.cu`` so that a zstd read waits on
the card once; each has a plain version in this module that the CPU route
runs and the CUDA kernels are held to.

* :func:`stitch` (one CTA): the decoders' flags, each block's place in its
  frame (segments, output bytes, literal bytes), each block's repeat-offset
  entry state, every block and frame check, and the replay's segment count
  and length a frame; all checks land in one int32 **record**.
* :func:`layout` (a CTA a block, then one a raw or RLE literal run): the
  replay's four segment tables, the "match beyond decoded history" check,
  the repeat-offset underflow flag; the literal runs copied into the rows.
* :func:`trim` (a grid over the output): the replay's rows cut to the
  frames' bytes back to back, behind a copy of the record with the
  replay's error word, for one read-back.

The record: ``REC_WORDS`` int32 (the ``REC_*`` words, zero where no check
failed; ``REC_FSE_ITEM`` and ``REC_LAYOUT`` are ``NONE`` then), followed by
each frame's computed output size as int64.  :func:`first_error` turns it
into the DecompressError of the first failed check, in the order the checks
run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DecompressError
from ..utils.observe import launched

from . import _build

(REC_HUFFMAN, REC_FSE_CODE, REC_FSE_ITEM, REC_FSE_POS, REC_REP, REC_LAYOUT, REC_BEYOND,
 REC_REPLAY, REC_RESIZE) = range(9)
#: int32 words of the record before the frames' sizes
REC_WORDS = 16
#: "no failing item or block" in ``REC_FSE_ITEM`` and ``REC_LAYOUT``
NONE = 2**31 - 1
#: bytes a block regenerates at most (RFC 8878)
MAX_BLOCK = 128 << 10
#: the layout checks by kind, the low two bits of ``REC_LAYOUT``
LAYOUT_ERRORS = ("literal run overruns literals", "block regenerated size too large",
                 "zstd output exceeds expected size")


def new_record(F: int, device) -> torch.Tensor:
    """An unwritten record for ``F`` frames: int32, ``REC_WORDS + 2 F``."""
    return torch.empty(REC_WORDS + 2 * F, dtype=torch.int32, device=device)


def record_sizes(rec) -> np.ndarray:
    """Each frame's computed output size, from a record on the host."""
    return np.asarray(rec[REC_WORDS:]).view(np.int64)


def first_error(rec) -> DecompressError | None:
    """The DecompressError of the first failed check in ``rec`` (a record
    on the host), in the order the checks run: the Huffman streams, the
    offset codes, the first sequence section not consumed exactly, the
    repeat offsets, the block and frame checks in block order, a match
    beyond decoded history; None where all passed."""
    if rec[REC_HUFFMAN]:
        return DecompressError("huffman stream not fully consumed")
    if rec[REC_FSE_CODE]:
        return DecompressError("offset code out of device range")
    if rec[REC_FSE_ITEM] != NONE:
        return DecompressError("sequence bitstream not fully consumed"
                               if rec[REC_FSE_POS] > 0 else "sequence bitstream over-read")
    if rec[REC_REP]:
        return DecompressError("repeat offset underflow")
    if rec[REC_LAYOUT] != NONE:
        return DecompressError(LAYOUT_ERRORS[int(rec[REC_LAYOUT]) & 3])
    if rec[REC_BEYOND]:
        return DecompressError("match offset beyond decoded history")
    return None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def stitch_plain(blk, frame_first, seq_off, sel, val, sums, final, pos_f, ferr, declared, rec,
                 *, max_out: int = -1, cap: int = NONE):
    """The blocks of every frame, in order, in one host loop.

    blk: (NB, 3) int64 (frame, literal bytes, sequence item or -1), frames
    in order; frame_first: (F + 1,) int64, each frame's first block and NB
    last; seq_off: (B + 1,) int64; sel, val (B, 3) int32 and sums (B, 2)
    int64 (``sum_ll, sum_ml``) from ``fse_torch.rep_totals``; final (S,)
    int32 of the Huffman decode; pos_f (B,) int32 and ferr (B,) bool of the
    FSE decode; declared (F,) int64, each frame's declared size or -1;
    ``max_out`` the output bound or -1; ``cap`` the longest frame the
    replay may take.

    A frame starts from repeat offsets (1, 4, 8); a block with sequences
    takes the state as its entry and leaves the state its totals map it to
    (int32 arithmetic, wrapping).  A block's checks: its literals less
    ``sum_ll`` below zero (kind 0), more than ``MAX_BLOCK`` regenerated
    (kind 1); a frame's: the output to its end above ``max_out`` (kind 2,
    at its last block + 1, less 2).  The record gets the least key ``4 *
    block + kind``, the decoders' flags, and each frame's size; a declared
    size that differs sets ``REC_RESIZE``.  A frame gets a replay count and
    length of 0 where any block check failed, its declared size differs,
    or its length exceeds ``cap``.

    Returns ``entry`` (B, 3) int32, ``bases`` (NB + 1, 3) int64 (each
    block's exclusive sums over all blocks of segments, output and literal
    bytes; the totals last) and ``frame_out`` (2, F) int32 (the replay's
    segment count, then length); writes ``rec``."""
    blk_n = blk.numpy().reshape(-1, 3)
    ff, so = frame_first.numpy(), seq_off.numpy()
    sel_n, val_n, sums_n = sel.numpy(), val.numpy(), sums.numpy()
    nb, F, B = len(blk_n), len(ff) - 1, len(so) - 1
    n_seq = np.diff(so)
    entry = np.zeros((B, 3), np.int32)
    bases = np.zeros((nb + 1, 3), np.int64)
    key, rep, acc = NONE, None, [0, 0, 0]
    for i, (frame, lt, slot) in enumerate(blk_n.tolist()):
        if i == 0 or frame != blk_n[i - 1, 0]:
            rep = [1, 4, 8]
        bases[i] = acc
        if slot < 0:
            acc[0] += int(lt > 0)
            acc[1] += lt
        else:
            sll, sml = sums_n[slot].tolist()
            tail, produced = lt - sll, lt + sml
            if key == NONE and (tail < 0 or produced > MAX_BLOCK):
                key = 4 * i + (tail >= 0)
            entry[slot] = rep
            rep = [v if s == 3 else _wrap32(rep[s] + v)
                   for s, v in zip(sel_n[slot].tolist(), val_n[slot].tolist())]
            acc[0] += int(n_seq[slot]) + int(tail > 0)
            acc[1] += produced
        acc[2] += lt
    bases[nb] = acc
    total = bases[ff[1:], 1] - bases[ff[:-1], 1]
    nseg = bases[ff[1:], 0] - bases[ff[:-1], 0]
    fkey = NONE
    if max_out >= 0:
        over = np.flatnonzero(bases[ff[1:], 1] > max_out)
        if over.size:
            fkey = int(4 * ff[over[0] + 1] - 2)
    dec = declared.numpy()
    wrong = (dec >= 0) & (dec != total)
    ok = (key == NONE) & ~wrong & (total <= cap) & (nseg <= NONE)
    frame_out = np.stack([np.where(ok, nseg, 0), np.where(ok, total, 0)]).astype(np.int32)
    pf = pos_f.numpy()
    bad = np.flatnonzero((pf != 0) & (n_seq > 0))
    head = np.zeros(REC_WORDS, np.int32)
    head[REC_HUFFMAN] = bool((final.numpy() != 0).any())
    head[REC_FSE_CODE] = bool(ferr.numpy().any())
    head[REC_FSE_ITEM] = bad[0] if bad.size else NONE
    head[REC_FSE_POS] = pf[bad[0]] if bad.size else 0
    head[REC_LAYOUT] = min(key, fkey)
    head[REC_RESIZE] = bool(wrong.any())
    rec[:REC_WORDS] = torch.from_numpy(head)
    rec[REC_WORDS:] = torch.from_numpy(total.astype(np.int64).view(np.int32))
    return (torch.from_numpy(entry), torch.from_numpy(bases),
            torch.from_numpy(np.ascontiguousarray(frame_out)))


def _before(v, which, n: int):
    """The sums of ``v`` over the groups before each of ``n`` groups."""
    per = torch.zeros(n, dtype=v.dtype).index_add_(0, which, v)
    return torch.cumsum(per, 0) - per


def layout_plain(blk, frame_first, bases, seq_off, lls, mls, offs, sums, rep_err, rec, *,
                 SB: int, runs, run_src, lits):
    """The replay's segment tables of every frame, in plain PyTorch.

    Block i of frame j starts at column ``j * SB`` plus its segments before
    it in the frame, at output and literal positions its bytes before it
    in the frame (``bases`` of :func:`stitch_plain`, less those of the
    frame's first block).  A block with sequences gives each sequence a
    segment (start, literals' start, ``ll``, offset), then its literal tail
    ``lt - sum_ll`` where positive; a literal-only block of ``lt > 0``
    bytes one segment.  Sets ``REC_BEYOND`` where a match (``ml > 0``)
    reaches before its frame (offset above the segment's start plus
    ``ll``) and ``REC_REP`` where ``rep_err`` is set; writes each literal
    run ``(length, destination, source, step)`` into ``lits`` from
    ``run_src``.

    Returns seg (4, F * SB) int32: seg_start, lit_start, lit_len, offset,
    zero in columns no segment takes."""
    i64 = torch.int64
    blk = blk.reshape(-1, 3)
    ff = frame_first
    F = ff.numel() - 1
    seg = torch.zeros((4, F * SB), dtype=torch.int32)
    frame, lt, slot = blk.unbind(1)
    b0 = bases[ff[frame]]
    bi = bases[:blk.shape[0]]
    col0 = frame * SB + bi[:, 0] - b0[:, 0]
    ob, lb = bi[:, 1] - b0[:, 1], bi[:, 2] - b0[:, 2]

    def put(cols, *vals):
        for row, v in enumerate(vals):
            seg[row, cols] = v.to(torch.int32) if torch.is_tensor(v) else v

    only = (slot < 0) & (lt > 0)
    put(col0[only], ob[only], lb[only], lt[only], 0)
    has = slot >= 0
    if has.any():
        blocks = torch.nonzero(has).flatten()
        items = slot[blocks]
        n = seq_off[items + 1] - seq_off[items]
        which = torch.repeat_interleave(torch.arange(len(items)), n)
        first = (seq_off[items] - (torch.cumsum(n, 0) - n))[which]
        q = torch.arange(which.numel()) + first  # flat sequence index
        ll, ml, off = (t[q].to(i64) for t in (lls, mls, offs))
        # exclusive sums within each block: over all sequences, less the
        # blocks' before
        ex, ey = ((torch.cumsum(v, 0) - v) - _before(v, which, len(items))[which]
                  for v in (ll + ml, ll))
        b = blocks[which]
        st = ob[b] + ex
        put(col0[b] + (q - seq_off[items][which]), st, lb[b] + ey, ll, off)
        if bool(((ml > 0) & (off > st + ll)).any()):
            rec[REC_BEYOND] = 1
        sll, sml = sums[items, 0], sums[items, 1]
        tail = lt[blocks] - sll
        t = tail > 0
        put((col0[blocks] + n)[t], (ob[blocks] + sll + sml)[t], (lb[blocks] + sll)[t], tail[t], 0)
    if rep_err.numel() and bool(rep_err.any()):
        rec[REC_REP] = 1
    for length, dst, src, step in runs.tolist():
        k = torch.arange(length)
        lits[dst + k] = run_src[src + k * step]
    return seg


def trim_plain(rows, off, state, rec):
    """The record, its ``REC_REPLAY`` word the replay's error word
    (``state[0]``, or 0 without a replay), as bytes, then frame j's first
    ``off[j + 1] - off[j]`` bytes of row j of ``rows`` (F, n_out), back to
    back (``rows`` None where every frame is empty)."""
    head = rec.clone()
    head[REC_REPLAY] = int(state[0]) if state is not None else 0
    parts = [head.view(torch.uint8)]
    n_out = 0 if rows is None else rows.shape[1]
    for j, (a, b) in enumerate(zip(off[:-1].tolist(), off[1:].tolist())):
        if b > a:
            parts.append(rows.reshape(-1)[j * n_out:j * n_out + b - a])
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Wrappers: the plain versions on the CPU, the kernels on a GPU
# ---------------------------------------------------------------------------


def _launch(name: str, dev, *args) -> None:
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"zp_{name}")(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    launched(name)


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _check(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def stitch(blk, frame_first, seq_off, sel, val, sums, final, pos_f, ferr, declared, rec, *,
           max_out: int = -1, cap: int = NONE):
    """:func:`stitch_plain` on the CPU; on a GPU, ``zp_zstd_stitch``
    (``csrc/zstd_assemble.cu``).  Same inputs, same outputs."""
    args = dict(blk=blk, frame_first=frame_first, seq_off=seq_off, sel=sel, val=val, sums=sums,
                final=final, pos_f=pos_f, ferr=ferr, declared=declared, rec=rec)
    dev = blk.device
    if dev.type == "cpu":
        return stitch_plain(*args.values(), max_out=max_out, cap=cap)
    if dev.type != "cuda":
        raise ValueError("stitch takes CPU or CUDA tensors")
    _check(dev, **args)
    nb, F, B = blk.shape[0], frame_first.numel() - 1, seq_off.numel() - 1
    if rec.numel() != REC_WORDS + 2 * F:
        raise ValueError("rec must hold REC_WORDS + 2 F int32")
    entry = torch.empty((B, 3), dtype=torch.int32, device=dev)
    bases = torch.empty((nb + 1, 3), dtype=torch.int64, device=dev)
    frame_out = torch.empty((2, F), dtype=torch.int32, device=dev)
    _launch("zstd_stitch", dev, _ptr(blk), nb, _ptr(frame_first), F, _ptr(seq_off), _ptr(sel),
            _ptr(val), _ptr(sums), B, _ptr(final), final.numel(), _ptr(pos_f), _ptr(ferr),
            _ptr(declared), max_out, min(cap, NONE), _ptr(entry), _ptr(bases), _ptr(frame_out),
            _ptr(rec))
    return entry, bases, frame_out


def layout(blk, frame_first, bases, seq_off, lls, mls, offs, sums, rep_err, rec, *, SB: int,
           runs, run_src, lits):
    """:func:`layout_plain` on the CPU; on a GPU, ``zp_zstd_layout``.  The
    kernel writes the columns segments take and leaves the others as they
    were: the replay reads none of them."""
    dev = blk.device
    kw = dict(SB=SB, runs=runs, run_src=run_src, lits=lits)
    if dev.type == "cpu":
        return layout_plain(blk, frame_first, bases, seq_off, lls, mls, offs, sums, rep_err,
                            rec, **kw)
    if dev.type != "cuda":
        raise ValueError("layout takes CPU or CUDA tensors")
    _check(dev, blk=blk, frame_first=frame_first, bases=bases, seq_off=seq_off, lls=lls,
           mls=mls, offs=offs, sums=sums, rep_err=rep_err, rec=rec, runs=runs, lits=lits)
    F = frame_first.numel() - 1
    seg = torch.empty((4, F * SB), dtype=torch.int32, device=dev)
    nb, R = blk.shape[0], runs.shape[0]
    if nb + R:
        _launch("zstd_layout", dev, _ptr(blk), nb, _ptr(frame_first), _ptr(bases), _ptr(seq_off),
                _ptr(lls), _ptr(mls), _ptr(offs), _ptr(sums), _ptr(rep_err), SB, _ptr(seg),
                F * SB, _ptr(runs), R, _ptr(run_src), _ptr(lits), _ptr(rec))
    return seg


def trim(rows, off, state, rec, *, total: int):
    """:func:`trim_plain` on the CPU; on a GPU, ``zp_zstd_trim``, into a
    new uint8 tensor of the record's bytes plus ``total`` (``off[-1]``,
    which the host knows)."""
    dev = rec.device
    if dev.type == "cpu":
        return trim_plain(rows, off, state, rec)
    if dev.type != "cuda":
        raise ValueError("trim takes CPU or CUDA tensors")
    _check(dev, off=off, rec=rec, **({} if rows is None else {"rows": rows}))
    out = torch.empty(4 * rec.numel() + total, dtype=torch.uint8, device=dev)
    n_out = 0 if rows is None else rows.shape[1]
    _launch("zstd_trim", dev, _ptr(rows), n_out, _ptr(off), off.numel() - 1, total,
            _ptr(state), _ptr(rec), rec.numel(), _ptr(out))
    return out
