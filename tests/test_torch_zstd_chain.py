"""The zstd read's native host layout (``native/zstd_read.cpp`` through
``kernels/zstd_chain.py``) against what the read's Python route computes in
numpy (``extract.read_shape``, ``extract.uploads``, ``extract.stage_places``
and the wrappers' own sizing), field by field: each frame's first block,
the declared sizes or the exact path, the frames' offsets, the segment
table's width, the decoders' shapes and stage sizes, the replay's row
length, stride and tiles, and the packed upload byte for byte at the
places ``stage`` gives it; every device buffer at the size its wrapper
allocates; on the corruption sweeps, the same inputs accepted and refused;
and the slot lists and constants the Python, C++ and CUDA halves share."""

import pathlib
import re

import numpy as np
import pytest
import torch
import zstandard

from zbench.gen import desktop
from zpack_tpu_torch import native
from zpack_tpu_torch.codecs.zstd import ZstdCodec
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import (assemble_cases, assemble_torch, fse_torch, huffman_torch,
                                     lz4_torch, zstd_chain)
from zpack_tpu_torch.parallel import extract

torch.set_num_threads(1)

CSRC = pathlib.Path(zstd_chain.__file__).resolve().parent.parent / "csrc"
KINDS = ("text", "markup", "records", "binary", "media")
SIZES = (4 << 10, 64 << 10, 1 << 20)


def _entry(kind: str, size: int) -> tuple:
    data = desktop.generate(np.random.default_rng([KINDS.index(kind), size]), size,
                            {"content": kind}, None).tobytes()
    return ZstdCodec().compress(data, 3), data


def _inputs() -> dict:
    rng = np.random.default_rng(23)
    text = _entry("text", 40_000)[1]
    skew = np.minimum(rng.geometric(0.05, 3000), 255).astype(np.uint8).tobytes()
    no_size = zstandard.ZstdCompressor(level=3, write_content_size=False)
    out = {f"{kind} {size}": _entry(kind, size) for kind in KINDS for size in SIZES}
    out.update({
        "multi-frame": (b"".join(native.zstd_compress(text[i:i + 9_000], 3)
                                 for i in range(0, 40_000, 9_000)), text),
        "raw only": (native.zstd_compress(rng.bytes(70_000), 3), None),
        "literals alone": (native.zstd_compress(skew, 3), skew),
        "rle": (native.zstd_compress(b"\x07" * 300_000, 3), b"\x07" * 300_000),
        "empty frame": (native.zstd_compress(b"", 3), b""),
        "no declared size": (no_size.compress(text), text),
        "frames with and without a size": (native.zstd_compress(text[:9000], 3)
                                           + no_size.compress(text), text[:9000] + text),
    })
    return out


INPUTS = _inputs()
#: the upload's arrays by ``stage``'s key, and their layout slots
UP_SLOTS = {"blk": "UP_BLK", "frame_first": "UP_FIRST", "seq_off": "UP_SEQ_OFF",
            "runs": "UP_RUNS", "declared": "UP_DECLARED", "offsets": "UP_OFFSETS",
            "source": "UP_SOURCE", "huf_rows": "UP_HUF_ROWS", "huf_tables": "UP_HUF_TABLES",
            "fse_rows": "UP_FSE_ROWS", "fse_al": "UP_FSE_AL", "fse_tables": "UP_FSE_TABLES"}


def _aligned(n: int) -> int:
    return -(-n // extract.STAGE_ALIGN) * extract.STAGE_ALIGN


def _python_refusal(plan, shape) -> str | None:
    """The ValueError the Python route's wrappers raise before a launch, in
    their order: the Huffman stage size, the FSE decode's limits, the
    replay's (``huffman_torch.stage_size``, ``fse_torch.decode_seq_streams``,
    ``lz4_torch.replay_enqueue``)."""
    try:
        if plan.huffman is not None:
            huffman_torch.stage_size(plan.huffman["widest"])
        if plan.sequences is not None:
            _, widest, longest = fse_torch.decode_shape(plan.sequences["rows"],
                                                        plan.sequences["seq_off"])
            if longest >= 1 << 23 or widest >= 1 << 26:
                raise ValueError("fse")
        if shape.sizes is not None:
            _replay_shape(len(plan.frame_chk), shape.sizes)
    except ValueError as e:
        return str(e)
    return None


def _replay_shape(F: int, sizes) -> dict:
    """``lz4_torch.replay_enqueue``'s row length, stride and tiles, and the
    trim's bytes, for frames of ``sizes``."""
    n_out = int(np.max(sizes))
    fstride = -(-n_out // 4) * 4
    tiles = F * -(-fstride // lz4_torch.REPLAY_TILE) if n_out else 0
    if n_out and (tiles >= 2**31 or fstride >= 2**31):
        raise ValueError("replay")
    return {"TOTAL": int(np.sum(sizes)), "N_OUT": n_out, "FSTRIDE": fstride, "TILES": tiles}


def _arena_sizes(lay, plan) -> list:
    """(slot, bytes) of part A's buffers in arena order, each the size its
    wrapper allocates; None where the wrapper has none."""
    F, NB, LB = len(plan.frame_chk), len(plan.blocks), plan.lit_row
    SB = extract.segment_width(plan)
    S = 0 if plan.huffman is None else len(plan.huffman["rows"])
    B = 0 if plan.sequences is None else len(plan.sequences["rows"])
    n = lay["SEQS"]
    seq = (lambda b: b if B else None)
    return [("A_LITS", F * LB), ("A_FINAL", 4 * S), ("A_LLS", seq(4 * n)), ("A_MLS", seq(4 * n)),
            ("A_OVS", seq(4 * n)), ("A_FREC", seq(8 * n)), ("A_POS_F", seq(4 * B)),
            ("A_FERR", seq(B)), ("A_SEL", seq(12 * B)), ("A_VAL", seq(12 * B)),
            ("A_SUMS", seq(16 * B)), ("A_REC", 4 * (assemble_torch.REC_WORDS + 2 * F)),
            ("A_ENTRY", seq(12 * B)), ("A_BASES", 24 * (NB + 1)), ("A_FRAME_OUT", 8 * F),
            ("A_OFFS", seq(4 * n)), ("A_REP_ERR", seq(B)), ("A_SEG", 16 * F * SB)]


def _part_b_sizes(lay, F: int) -> list:
    replay = lay["N_OUT"] > 0
    return [("B_OFFSETS", 8 * (F + 1)), ("B_ROWS", F * lay["N_OUT"] if replay else None),
            ("B_F", 4 * F * lay["FSTRIDE"] if replay else None),
            ("B_LIVE", 4 * lay["TILES"] if replay else None),
            ("B_STATE", 4 * lz4_torch.REPLAY_STATE if replay else None),
            ("B_OUT", 4 * lay["REC_WORDS"] + lay["TOTAL"])]


def _placed(lay, sizes: list, start: int, end_slot: str) -> None:
    """Each buffer of ``sizes`` right after the one before, at a multiple
    of the alignment, and the region's end at ``end_slot``."""
    pos = start
    for slot, n in sizes:
        if n is None:
            assert lay[slot] == -1, slot
            continue
        assert lay[slot] == pos, slot
        pos += _aligned(n)
    assert lay[end_slot] == pos


def _held_to_numpy(plan, max_out) -> zstd_chain.Layout:
    """The native layout of ``plan``, held to the Python route's numpy
    field by field; returns it."""
    F = len(plan.frame_chk)
    shape = extract.read_shape(plan, max_out)
    lay = zstd_chain.Layout(plan, max_out)
    huf, fse = plan.huffman, plan.sequences
    assert (lay["F"], lay["NB"], lay["LB"], lay["N"]) == \
        (F, len(plan.blocks), plan.lit_row, plan.source.size)
    assert lay["EXACT"] == (shape.sizes is None)
    assert (lay["SB"], lay["CAP"]) == (extract.segment_width(plan), shape.cap)
    assert lay["MAX_OUT"] == (-1 if max_out is None else max_out)
    assert lay["REC_WORDS"] == assemble_torch.REC_WORDS + 2 * F
    assert lay["HUF_STAGE"] == (0 if huf is None else huffman_torch.stage_size(huf["widest"]))
    want = (0, 0, 0) if fse is None else fse_torch.decode_shape(fse["rows"], fse["seq_off"])
    assert (lay["SEQS"], lay["FSE_WIDEST"], lay["FSE_LONGEST"]) == want
    if shape.sizes is not None:
        assert {k: lay[k] for k in ("TOTAL", "N_OUT", "FSTRIDE", "TILES")} == \
            _replay_shape(F, shape.sizes)
    # the upload: every array at the place stage() gives it, byte for byte
    up = extract.uploads(plan, shape)
    places, total = extract.stage_places(up)
    assert lay["UP_BYTES"] == total
    for key, slot in UP_SLOTS.items():
        assert lay[slot] == places.get(key, -1), key
    pinned = torch.zeros(lay["PIN_BYTES"], dtype=torch.uint8)
    lay.pack(pinned)
    got = pinned.numpy()
    for key, a in up.items():
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        assert np.array_equal(got[places[key]:places[key] + raw.size], raw), key
    # every device buffer at its wrapper's size, back to back after the upload
    _placed(lay, _arena_sizes(lay, plan), total, "A_BYTES")
    if shape.sizes is not None:
        _placed(lay, _part_b_sizes(lay, F), 0, "B_BYTES")
        assert lay["BACK_BYTES"] == 4 * lay["REC_WORDS"] + lay["TOTAL"]
    else:
        assert lay["BACK_BYTES"] == 4 * lay["REC_WORDS"]
    assert (lay["PIN_BACK"], lay["PIN_BYTES"]) == (total, total + lay["BACK_BYTES"])
    return lay


@pytest.mark.parametrize("name", list(INPUTS))
def test_layout_equals_the_python_routes_numpy(name):
    comp, data = INPUTS[name]
    plan = extract.zstd_plan(comp)
    n = len(extract.decompress_zstd_device(comp, device="cpu")) if data is None else len(data)
    for max_out in (None, n, n - 1, n + 1000):
        if max_out is not None and max_out < 0:
            continue
        _held_to_numpy(plan, max_out)


@pytest.mark.parametrize("name,sizes", [("no declared size", [40_000]),
                                        ("frames with and without a size", [9000, 40_000]),
                                        ("text 65536", [65536]), ("empty frame", [0])])
def test_part_b_from_computed_sizes_equals_the_replays_numpy(name, sizes):
    """The exact path's part B: the replay's shape and buffers from the
    sizes the card computes, and part B's own pinned buffer."""
    comp, data = INPUTS[name]
    plan = extract.zstd_plan(comp)
    lay = _held_to_numpy(plan, None)
    F = len(plan.frame_chk)
    assert sum(sizes) == len(data) and len(sizes) == F
    lay.replay(np.array(sizes, np.int64))
    assert {k: lay[k] for k in ("TOTAL", "N_OUT", "FSTRIDE", "TILES")} == _replay_shape(F, sizes)
    _placed(lay, _part_b_sizes(lay, F), 0, "B_BYTES")
    assert lay["BACK_BYTES"] == 4 * lay["REC_WORDS"] + len(data)
    assert lay["PIN_BACK"] == _aligned(8 * (F + 1))
    assert lay["PIN_BYTES"] == lay["PIN_BACK"] + lay["BACK_BYTES"]


def test_layout_refuses_what_the_wrappers_refuse():
    """A Huffman row of 2**26 bytes, a block of 2**23 sequences and a frame
    too long for one replay: the wrappers' ValueError, in their order."""
    plan = extract.zstd_plan(INPUTS["text 65536"][0])
    rows = plan.huffman["rows"].copy()
    rows[0, 1] = huffman_torch.MAX_ROW_BYTES
    wide = plan._replace(huffman={**plan.huffman, "rows": rows,
                                  "widest": huffman_torch.MAX_ROW_BYTES})
    with pytest.raises(ValueError, match="2\\*\\*26 bytes or more"):
        zstd_chain.Layout(wide, None)
    seqs = plan.sequences
    long_off = seqs["seq_off"].copy()
    long_off[1:] += 1 << 23
    with pytest.raises(ValueError, match="2\\*\\*23 sequences"):
        zstd_chain.Layout(plan._replace(sequences={**seqs, "seq_off": long_off}), None)
    lay = zstd_chain.Layout(plan, None)
    with pytest.raises(ValueError, match="too many bytes for one replay launch"):
        lay.replay(np.array([2**31 - 1], np.int64))
    assert _python_refusal(wide, extract.read_shape(wide, None)) is not None


def test_flip_sweeps_accept_and_refuse_what_the_python_route_does():
    """The 304 inputs of ``assemble_cases.flips``: each the walk refuses,
    or the read's route takes with its pending error, or the layout and
    the Python route's sizing both accept, field by field the same, or both
    refuse with one message."""
    rng = np.random.default_rng(64)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8)) for _ in range(200)]
    data = b" ".join(words[i] for i in rng.integers(0, 200, 7_500))[:30_000]
    kinds = {"walk": 0, "pending": 0, "laid out": 0, "refused": 0}
    for bad in assemble_cases.flips(native.zstd_compress(data, 3)):
        try:
            plan = extract.zstd_plan(bad)
        except DecompressError:
            kinds["walk"] += 1
            continue
        if plan.error is not None or not plan.frame_chk:
            kinds["pending"] += 1
            continue
        shape = extract.read_shape(plan, len(data))
        want = _python_refusal(plan, shape)
        try:
            _held_to_numpy(plan, len(data))
            got = None
        except ValueError as e:
            got = str(e)
        assert (got is None) == (want is None), (got, want)
        kinds["refused" if got else "laid out"] += 1
    assert sum(kinds.values()) == 304
    assert kinds["laid out"] > 100, kinds


# -- the slot lists and constants of the three halves ----------------------------

def _enum(text: str, name: str, prefix: str) -> list:
    body = re.search(rf"enum {name} : int \{{(.*?)\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == f"{prefix}SLOTS"
    return [n[len(prefix):] for n in names[:-1]]


def test_slot_lists_are_the_headers():
    text = (CSRC / "zstd_chain.cuh").read_text()
    assert tuple(_enum(text, "ZpSlot", "ZP_")) == zstd_chain.PLAN_SLOTS
    assert tuple(_enum(text, "ZrSlot", "ZR_")) == zstd_chain.SLOTS


def test_constants_are_the_pythons():
    text = (CSRC / "zstd_chain.cuh").read_text()
    got = {k: eval(v) for k, v in re.findall(r"constexpr int64_t (k\w+) = ([0-9 <]+);", text)}
    assert got == {"kAlign": extract.STAGE_ALIGN, "kRecWords": assemble_torch.REC_WORDS,
                   "kNone": assemble_torch.NONE, "kMaxBlock": assemble_torch.MAX_BLOCK,
                   "kReplayState": lz4_torch.REPLAY_STATE, "kReplayTile": lz4_torch.REPLAY_TILE,
                   "kHufStageCap": huffman_torch.STAGE_CAP,
                   "kHufMaxRow": huffman_torch.MAX_ROW_BYTES,
                   "kFseStageCap": fse_torch.STAGE_CAP, "kFseMaxSeqs": 1 << 23,
                   "kFseMaxRow": 1 << 26}
    parts = dict(re.findall(r"(kPart\w+) = (\d+),", text))
    assert {k: int(v) for k, v in parts.items()} == \
        {"kPartA": zstd_chain.PART_A, "kPartRestitch": zstd_chain.PART_RESTITCH,
         "kPartB": zstd_chain.PART_B}


def test_each_launch_reports_its_kernels_key():
    """Each ``run(code, zp_<key>(...))`` of the chain reports the code whose
    entry in ``KERNELS`` is the key its wrapper records, and every kernel
    of ``KERNELS`` is launched somewhere."""
    text = (CSRC / "zstd_chain.cu").read_text()
    codes = re.search(r"enum Kernel : int \{(.*?)\};", text, re.S).group(1)
    codes = [c.strip() for c in codes.split(",") if c.strip()]
    runs = re.findall(r"run\((k\w+), (zp_\w+)\(", text)
    assert len(codes) == len(zstd_chain.KERNELS)
    assert sorted({zstd_chain.KERNELS[codes.index(c)] for c, _ in runs}) == \
        sorted(zstd_chain.KERNELS)
    for code, fn in runs:
        assert fn == "zp_" + zstd_chain.KERNELS[codes.index(code)], (code, fn)
