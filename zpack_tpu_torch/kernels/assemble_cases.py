"""Batches that stress the zstd frame assembly (``assemble_torch``): one
definition for ``tests/test_torch_assemble_cases.py`` (the plain versions
against the host's layout loop, on the CPU) and ``tests/test_torch_cuda.py``
(the kernels against the plain versions).

A case is what the assembly gets from the decoders: each block's frame,
literal bytes and sequence item, the flat sequences (``lls``, ``mls`` and raw
offset values ``ovs``), the decoders' flags, each frame's declared size, the
output bound, the literal rows and the raw and RLE runs.  :func:`cases`
gives valid frames of every block kind (frames of no block and of one, the
stitch's tile of 256 blocks, the layout's tile of 1,024 sequences, the
trim's tile of 4,096 bytes, each on both sides), and every check made to
fail at the first and at the last block, item or frame it can.
:func:`assemble` runs a case through the assembly as the zstd route does;
:func:`flips` makes the corruption sweeps of a frame that the zstd read is
held to, on the CPU against the JAX function and on the card against the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import assemble_torch as A, fse_torch, lz4_torch

#: the tiles of ``csrc/zstd_assemble.cu``: blocks of the stitch CTA,
#: sequences of a layout CTA, bytes of a trim CTA
STITCH_TILE = 256
LAYOUT_TILE = 1024
TRIM_TILE = 4096


def build(frames: list, seed: int = 0) -> dict:
    """A valid case from ``frames``, each a list of blocks: ``("raw", n)``
    or ``("rle", n)`` (a literal run), ``("lits", n)`` (literals alone) or
    ``("seq", n_seq, tail)`` (sequences whose offsets stay inside the frame,
    then ``tail`` literals)."""
    rng = np.random.default_rng(seed)
    blk, runs, lls, mls, ovs, seq_off = [], [], [], [], [], [0]
    f_lits, f_out, frame_first, src = [], [], [0], []
    for j, blocks in enumerate(frames):
        lp = out = 0
        for b in blocks:
            if b[0] in ("raw", "rle", "lits"):
                n = b[1]
                if b[0] != "lits" and n:
                    step = 1 if b[0] == "raw" else 0
                    runs.append([n, (j, lp), sum(map(len, src)), step])
                    src.append(rng.integers(0, 256, n if step else 1, dtype=np.uint8))
                blk.append([j, n, -1])
                lp += n
                out += n
                continue
            _, n_seq, tail = b
            ll = rng.integers(0, 24, n_seq)
            ml = rng.integers(3, 40, n_seq)
            ov = np.zeros(n_seq, np.int64)
            for k in range(n_seq):
                if out == 0 and k == 0:
                    ll[k] = max(ll[k], 1)
                hist = out + ll[k]
                # a repeat of the last offset where a literal precedes, else new
                ov[k] = 1 if (k and ll[k] and rng.random() < 0.25) else 3 + rng.integers(1, hist + 1)
                out += ll[k] + ml[k]
            lt = int(ll.sum()) + tail
            blk.append([j, lt, len(seq_off) - 1])
            lls.append(ll)
            mls.append(ml)
            ovs.append(ov)
            seq_off.append(seq_off[-1] + n_seq)
            lp += lt
            out += tail
        f_lits.append(lp)
        f_out.append(out)
        frame_first.append(len(blk))
    F = len(frames)
    LB = max(max(f_lits, default=0), 1)
    runs_a = np.array([[n, j * LB + p, s, st] for n, (j, p), s, st in runs],
                      dtype=np.int64).reshape(-1, 4)
    B = len(seq_off) - 1
    cat = (lambda xs: np.concatenate(xs).astype(np.int32)) if lls else \
        (lambda xs: np.zeros(0, np.int32))
    blk_a = np.array(blk, dtype=np.int64).reshape(-1, 3)
    n_seq = np.diff(seq_off)
    per = np.ones(len(blk_a), np.int64)
    per[blk_a[:, 2] >= 0] += n_seq[blk_a[blk_a[:, 2] >= 0, 2]]
    return {"blk": blk_a, "frame_first": np.array(frame_first, np.int64),
            "seq_off": np.array(seq_off, np.int64), "lls": cat(lls), "mls": cat(mls),
            "ovs": cat(ovs), "final": np.zeros(max(B, 1), np.int32),
            "pos_f": np.zeros(B, np.int32), "ferr": np.zeros(B, np.bool_),
            "declared": np.array(f_out, np.int64), "max_out": -1,
            "lits": rng.integers(0, 256, F * LB, dtype=np.uint8), "LB": LB,
            "SB": max(int(np.bincount(blk_a[:, 0], per, minlength=F).max()), 1) if F else 1,
            "runs": runs_a,
            "run_src": np.concatenate(src) if src else np.zeros(0, np.uint8)}


def _edit(case: dict, **changes) -> dict:
    out = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in case.items()}
    for k, f in changes.items():
        f(out[k]) if callable(f) else out.__setitem__(k, f)
    return out


def _item_ends(case):
    """Each sequence item's first and last sequence."""
    so = case["seq_off"]
    return so[:-1], so[1:] - 1


def cases() -> dict:
    """Every case by name."""
    mixed = [[("seq", 40, 5), ("raw", 300), ("seq", 7, 0)], [("rle", 900)],
             [("lits", 77), ("seq", 60, 3), ("rle", 0), ("seq", 1, 1)], [("seq", 120, 0)]]
    base = build(mixed, 1)
    out = {"mixed": base,
           "one frame, one block": build([[("seq", 30, 4)]], 2),
           "a frame of one raw block": build([[("raw", 10)]], 3),
           "frames of no block": build([[], [("seq", 9, 2)], [], [("raw", 5)], []], 4),
           "empty frames only": build([[("raw", 0)], [("lits", 0)]], 5),
           "literals alone": build([[("lits", 500), ("lits", 0), ("lits", 3)]], 6)}
    for nb in (STITCH_TILE - 1, STITCH_TILE, STITCH_TILE + 1, 2 * STITCH_TILE + 1):
        frames = [[("seq", 2 + k % 5, k % 3) if k % 4 else ("raw", k % 7)
                   for k in range(f, nb, 3)] for f in range(3)]
        out[f"{nb} blocks"] = build(frames, nb)
    for n in (LAYOUT_TILE - 1, LAYOUT_TILE, LAYOUT_TILE + 1, 2 * LAYOUT_TILE + 1):
        out[f"a block of {n} sequences"] = build([[("seq", 3, 1), ("seq", n, 2)]], n)
    out["trim tiles"] = build([[("raw", TRIM_TILE - 1)], [("raw", TRIM_TILE)], [],
                               [("raw", TRIM_TILE + 1)], [("rle", 1)]], 7)
    # every check at the first and at the last place it can fail
    first, last = _item_ends(base)
    B = len(base["seq_off"]) - 1
    lt_of = {int(s): i for i, s in enumerate(base["blk"][:, 2]) if s >= 0}

    def lits_short(item):
        def f(blk):
            i = lt_of[item]
            blk[i, 1] = int(base["lls"][first[item]:last[item] + 1].sum()) - 1
        return f

    def big_match(item):
        def f(mls):
            mls[last[item]] = A.MAX_BLOCK
        return f

    def far(seq):
        def f(ovs):
            ovs[seq] = 3 + 10**6
        return f

    out["overrun at the first block"] = _edit(base, blk=lits_short(0))
    out["overrun at the last block"] = _edit(base, blk=lits_short(B - 1))
    out["too large at the first block"] = _edit(base, mls=big_match(0))
    out["too large at the last block"] = _edit(base, mls=big_match(B - 1))
    sizes = base["declared"]
    out["output bound at the first frame"] = _edit(base, max_out=int(sizes[0]) - 1)
    out["output bound at the last frame"] = _edit(base, max_out=int(sizes.sum()) - 1)
    out["beyond at the first block"] = _edit(base, ovs=far(0))
    out["beyond at the last block"] = _edit(base, ovs=far(int(last[-1])))
    # r0 - 1 with no literal at a frame's start: offset 0
    for name, item in (("first", 0), ("last", B - 1)):
        def f(c, s=int(first[item])):
            c["lls"][s], c["ovs"][s] = 0, 3
        c = _edit(base)
        f(c)
        out[f"rep underflow at the {name} item"] = c
    out["huffman at the first stream"] = _edit(base, final=lambda a: a.__setitem__(0, 5))
    out["huffman at the last stream"] = _edit(base, final=lambda a: a.__setitem__(-1, -3))
    out["offset code at the first item"] = _edit(base, ferr=lambda a: a.__setitem__(0, True))
    out["offset code at the last item"] = _edit(base, ferr=lambda a: a.__setitem__(-1, True))
    out["unconsumed at the first item"] = _edit(base, pos_f=lambda a: a.__setitem__(0, 7))
    out["over-read at the last item"] = _edit(base, pos_f=lambda a: a.__setitem__(-1, -2))
    out["over-read before unconsumed"] = _edit(
        base, pos_f=lambda a: (a.__setitem__(1, -4), a.__setitem__(2, 9)))
    out["declared size wrong at the first frame"] = _edit(
        base, declared=lambda a: a.__setitem__(0, a[0] + 1))
    out["declared size wrong at the last frame"] = _edit(
        base, declared=lambda a: a.__setitem__(-1, a[-1] - 1))
    out["overrun and beyond: the overrun first"] = _edit(base, blk=lits_short(B - 1),
                                                          ovs=far(0))
    return out


def flips(frame: bytes) -> list:
    """The corruption sweeps the zstd read is held to: ``frame`` with one
    byte flipped (xor 0x5A) at 16 positions spread over it, then with the
    masks 0x01, 0x80 and 0xFF at 32 spread positions and at each of its
    first 64 bytes (the frame, block and literals headers and the Huffman
    tree): 16 + 288 inputs."""
    out = []
    spread = np.linspace(4, len(frame) - 1, 32).astype(int).tolist()
    for positions, masks in ((np.linspace(4, len(frame) - 1, 16).astype(int).tolist(), (0x5A,)),
                             (spread + list(range(4, 68)), (0x01, 0x80, 0xFF))):
        for p in positions:
            for m in masks:
                bad = bytearray(frame)
                bad[p] ^= m
                out.append(bytes(bad))
    return out


def assemble(case: dict, device) -> dict:
    """A case through the assembly as the zstd route runs it on
    ``device``: repeat-offset totals, stitch, offsets, layout, replay and
    trim.  Returns the host arrays: ``entry``, ``bases``, ``frame_out``,
    the record, each frame's segments (the columns they take), the literal
    rows and the trimmed output."""
    dev = torch.device(device)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in case.items()
         if isinstance(v, np.ndarray)}
    F = len(case["frame_first"]) - 1
    B = len(case["seq_off"]) - 1
    SB, LB = case["SB"], case["LB"]
    if B:
        sel, val, sums = fse_torch.rep_totals(t["ovs"], t["lls"], t["mls"], t["seq_off"])
    else:
        sel = val = torch.zeros((0, 3), dtype=torch.int32, device=dev)
        sums = torch.zeros((0, 2), dtype=torch.int64, device=dev)
    rec = A.new_record(F, dev)
    declared = t["declared"]
    entry, bases, frame_out = A.stitch(
        t["blk"], t["frame_first"], t["seq_off"], sel, val, sums, t["final"], t["pos_f"],
        t["ferr"], declared, rec, max_out=case["max_out"],
        cap=int(case["declared"].max(initial=0)))
    if B:
        offs, rep_err = fse_torch.rep_apply(t["ovs"], t["lls"], t["seq_off"], entry)
    else:
        offs, rep_err = t["lls"], t["ferr"]
    lits = t["lits"]
    seg = A.layout(t["blk"], t["frame_first"], bases, t["seq_off"], t["lls"], t["mls"], offs,
                   sums, rep_err, rec, SB=SB, runs=t["runs"], run_src=t["run_src"], lits=lits)
    sizes = case["declared"]
    n_out = int(sizes.max(initial=0))
    rows, state = lz4_torch.replay_enqueue(
        lits.view(F, LB), *(s.view(F, SB) for s in seg), frame_out[0], frame_out[1],
        n_out=n_out) if n_out else (None, None)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)).to(dev)
    out = A.trim(rows, off, state, rec, total=int(sizes.sum())).cpu().numpy()
    fo = frame_out.cpu().numpy()
    seg_h = seg.cpu().numpy().reshape(4, F, SB)
    nseg = np.diff(bases.cpu().numpy()[case["frame_first"], 0])
    return {"entry": entry.cpu().numpy(), "bases": bases.cpu().numpy(), "frame_out": fo,
            "rec": out[:4 * rec.numel()].view(np.int32).copy(),
            "segs": [seg_h[:, j, :nseg[j]].copy() for j in range(F)],
            "lits": lits.cpu().numpy(), "out": out[4 * rec.numel():].copy()}
