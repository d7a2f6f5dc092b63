"""The zstd frame assembly's plain versions (``kernels/assemble_torch.py``)
on the batches of ``kernels/assemble_cases.py``, held to a statement of the
layout as a host loop over the blocks: the repeat-offset entry states
stitched block by block with ``fse_torch.eval_rep_map``, each frame's
segments, literal tails and literal-only blocks placed in block order, the
checks raised in the loop's order, the segment starts by prefix sums, and the
frames replayed and joined.  The CUDA kernels are held to the plain versions
in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from zpack_tpu_torch.kernels import assemble_cases as C, assemble_torch as A, fse_torch, lz4_torch

torch.set_num_threads(1)

CASES = C.cases()


def _host(case: dict) -> dict:
    """The host's assembly: the entry states, each frame's segments and
    bytes, and the first error, in the order the host raised them."""
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    blk, ff, so = case["blk"], case["frame_first"], case["seq_off"]
    B, F = len(so) - 1, len(ff) - 1
    n_seq = np.diff(so)
    errors = []
    if (case["final"] != 0).any():
        errors.append("huffman stream not fully consumed")
    if case["ferr"].any():
        errors.append("offset code out of device range")
    bad = np.flatnonzero((n_seq > 0) & (case["pos_f"] != 0))
    if bad.size:
        errors.append("sequence bitstream not fully consumed" if case["pos_f"][bad[0]] > 0
                      else "sequence bitstream over-read")
    entry = np.zeros((B, 3), np.int32)
    offs = torch.zeros(0, dtype=torch.int32)
    sums = np.zeros((B, 2), np.int64)
    if B:
        sel, val, s = (x.numpy() for x in fse_torch.rep_totals_plain(
            t["ovs"], t["lls"], t["mls"], t["seq_off"]))
        sums = s
        for j in range(F):
            rep = [1, 4, 8]
            for slot in blk[ff[j]:ff[j + 1], 2]:
                if slot >= 0:
                    entry[slot] = rep
                    rep = fse_torch.eval_rep_map(sel[slot], val[slot], rep)
        offs, err = fse_torch.rep_apply_plain(t["ovs"], t["lls"], t["seq_off"],
                                              torch.from_numpy(entry))
        if err.any():
            errors.append("repeat offset underflow")
    # the layout loop, frame by frame in block order
    segs, f_total, layout_err, beyond = [], [], None, False
    done = 0
    for j in range(F):
        cols = []  # (ll, ml, off) a segment
        total = 0
        for i in range(ff[j], ff[j + 1]):
            _, lt, slot = blk[i].tolist()
            if slot < 0:
                total += lt
                if lt:
                    cols.append((lt, 0, 0))
                continue
            tail = lt - int(sums[slot, 0])
            if tail < 0 and layout_err is None:
                layout_err = "literal run overruns literals"
            produced = lt + int(sums[slot, 1])
            if produced > A.MAX_BLOCK and layout_err is None:
                layout_err = "block regenerated size too large"
            total += produced
            a, b = so[slot], so[slot + 1]
            cols += zip(case["lls"][a:b].tolist(), case["mls"][a:b].tolist(),
                        offs[a:b].tolist())
            if tail > 0:
                cols.append((tail, 0, 0))
        done += total
        if case["max_out"] >= 0 and done > case["max_out"] and layout_err is None:
            layout_err = "zstd output exceeds expected size"
        c = np.array(cols, np.int64).reshape(-1, 3)
        ll, ml, off = c.T
        seg_len = ll + ml
        st = np.cumsum(seg_len) - seg_len
        beyond |= bool(((ml > 0) & (off > st + ll)).any())
        segs.append(np.stack([st, np.cumsum(ll) - ll, ll, off]))
        f_total.append(total)
    if layout_err is not None:
        errors.append(layout_err)
    if beyond:
        errors.append("match offset beyond decoded history")
    lits = case["lits"].copy()
    for n, dst, src, step in case["runs"].tolist():
        lits[dst + np.arange(n)] = case["run_src"][src + np.arange(n) * step]
    out = None
    if not errors:
        LB, SB = case["LB"], max(max((s.shape[1] for s in segs), default=0), 1)
        tabs = np.zeros((4, F, SB), np.int32)
        for j, s in enumerate(segs):
            tabs[:, j, :s.shape[1]] = s
        n_out = max(max(f_total, default=0), 1)
        rows = lz4_torch.replay_plain(
            torch.from_numpy(lits).view(F, LB), *(torch.from_numpy(x) for x in tabs),
            torch.tensor([s.shape[1] for s in segs], dtype=torch.int32),
            torch.tensor(f_total, dtype=torch.int32), n_out=n_out).numpy()
        out = b"".join(rows[j, :n].tobytes() for j, n in enumerate(f_total))
    return {"entry": entry, "segs": segs, "f_total": np.array(f_total, np.int64),
            "errors": errors, "lits": lits, "out": out}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_assembly_equals_the_host_loop(name):
    case = CASES[name]
    want = _host(case)
    got = C.assemble(case, "cpu")
    err = A.first_error(got["rec"])
    assert (str(err) if err else None) == (want["errors"][0] if want["errors"] else None)
    assert np.array_equal(got["entry"], want["entry"])
    assert np.array_equal(A.record_sizes(got["rec"]), want["f_total"])
    assert np.array_equal(got["lits"], want["lits"])
    if want["errors"][:1] and want["errors"][0] in A.LAYOUT_ERRORS[:2]:
        return  # the host stopped there; the tables past it are not the host's
    assert len(got["segs"]) == len(want["segs"])
    for g, w in zip(got["segs"], want["segs"]):
        assert np.array_equal(g.astype(np.int64), w)
    resize = bool(got["rec"][A.REC_RESIZE])
    assert resize == bool((case["declared"] != want["f_total"]).any())
    if want["out"] is not None and not resize:
        assert got["out"].tobytes() == want["out"]
        fo = got["frame_out"]
        assert np.array_equal(fo[1], want["f_total"])
        assert np.array_equal(fo[0], [s.shape[1] for s in want["segs"]])


def test_cases_reach_every_check_at_both_ends():
    """Each check fails in two cases, at its first and its last place, and
    every valid case passes them all."""
    errs = {}
    for name, case in CASES.items():
        err = A.first_error(C.assemble(case, "cpu")["rec"])
        errs.setdefault(str(err) if err else None, []).append(name)
    for msg in ("huffman stream not fully consumed", "offset code out of device range",
                "sequence bitstream not fully consumed", "sequence bitstream over-read",
                "repeat offset underflow", *A.LAYOUT_ERRORS,
                "match offset beyond decoded history"):
        assert msg in errs, msg
    assert len(errs[None]) >= 15


def test_a_frame_gets_no_replay_where_a_block_check_failed_or_its_size_is_wrong():
    base = CASES["mixed"]
    got = C.assemble(CASES["overrun at the first block"], "cpu")
    assert not got["frame_out"].any()  # every frame: the tables are not to be trusted
    got = C.assemble(CASES["declared size wrong at the last frame"], "cpu")
    assert got["frame_out"][:, -1].tolist() == [0, 0]
    assert np.array_equal(got["frame_out"][:, :-1], C.assemble(base, "cpu")["frame_out"][:, :-1])


def test_first_error_keeps_the_hosts_order():
    rec = np.zeros(A.REC_WORDS, np.int32)
    rec[A.REC_FSE_ITEM] = rec[A.REC_LAYOUT] = A.NONE
    assert A.first_error(rec) is None
    steps = [(A.REC_BEYOND, 1, "match offset beyond decoded history"),
             (A.REC_LAYOUT, 4 * 3 + 2, "zstd output exceeds expected size"),
             (A.REC_LAYOUT, 4 * 3 + 1, "block regenerated size too large"),
             (A.REC_LAYOUT, 4 * 3, "literal run overruns literals"),
             (A.REC_REP, 1, "repeat offset underflow"),
             (A.REC_FSE_ITEM, 2, "sequence bitstream over-read"),
             (A.REC_FSE_CODE, 1, "offset code out of device range"),
             (A.REC_HUFFMAN, 1, "huffman stream not fully consumed")]
    rec[A.REC_FSE_POS] = -1
    for word, value, msg in steps:  # each earlier check masks the later ones
        rec[word] = value
        assert str(A.first_error(rec)) == msg
