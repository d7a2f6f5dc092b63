"""The desktop file tree configuration (``zbench/configs/fstree/``) through
the port on the CPU: its sizes are the stated draw, its generator repeats
from the seed, and a slice of its members round-trips through the port's
``Writer`` and ``Reader.read_file`` on the device route with no step down,
equal to the content and to the benchmark's plain zstd decoder."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import zpack_tpu_torch as zp
from zbench import corpus
from zbench.gen import desktop
from zbench.reference.zstd import frame as ref_frame
from zbench.reference.zstd import seq as ref_seq
from zpack_tpu_torch import codecs, engine
from zpack_tpu_torch.codecs import zstd as zstd_codec

torch.set_num_threads(1)

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "zbench/configs/fstree/fstree-zstd3.json"
SEED = 2**40 + 5


@pytest.fixture(scope="module")
def cfg():
    return json.loads(CONFIG.read_text())


def test_sizes_are_the_stated_draw(cfg):
    draw = np.random.default_rng(20090224).normal(9.48, 2.46, 2048)
    sizes = np.maximum(1, np.rint(np.exp(draw))).astype(np.int64)
    assert [m["bytes"] for m in cfg["members"]] == sizes.tolist()
    assert sum(m["bytes"] for m in cfg["members"]) == 385_241_602
    assert cfg["sizes"]["total_bytes"] == 385_241_602
    assert cfg["sizes"]["median_bytes"] == 12_964 == int(np.median(sizes))
    assert cfg["file_count"] == len(cfg["members"]) == 2048
    assert cfg["reduced"] == ["file_count"]
    assert (cfg["method"], cfg["level"]) == (1, 3)


def test_names_kinds_and_assumptions(cfg):
    names = [m["name"] for m in cfg["members"]]
    assert len(set(names)) == 2048
    for i, name in enumerate(names):
        assert re.fullmatch(rf"d{i // 32:02d}/f{i:04d}\.[a-z]+", name), name
    kinds = [m["params"]["content"] for m in cfg["members"]]
    assert {m["kind"] for m in cfg["members"]} == {"desktop"}
    assert set(kinds) == set(desktop.CONTENTS)
    counts = {k: kinds.count(k) for k in desktop.CONTENTS}
    assert counts == cfg["kinds"]["counts"]
    draw = np.random.default_rng(20090225).choice(5, 2048, p=[0.30, 0.10, 0.10, 0.30, 0.20])
    assert kinds == [list(desktop.CONTENTS)[k] for k in draw]
    said = " ".join(cfg["assumed"])
    for word in ("text 40%", "records 10%", "binary 30%", "media 20%", "Pareto", "names"):
        assert word in said, word


def test_generator_repeats_from_the_seed(cfg):
    # one member of each kind, at a size of its own
    pick = {}
    for i, m in enumerate(cfg["members"]):
        if 1000 < m["bytes"] < 200_000:
            pick.setdefault(m["params"]["content"], i)
    sub = {**cfg, "members": [cfg["members"][i] for i in pick.values()]}
    a = corpus.build(sub, SEED, workers=3)
    b = corpus.build(sub, SEED, workers=1)
    c = corpus.build(sub, SEED + 1)
    assert a == b
    for (_, x), (_, y), m in zip(a, c, sub["members"]):
        assert len(x) == len(y) == m["bytes"]
        assert x != y


@pytest.mark.parametrize("content", sorted(desktop.CONTENTS))
@pytest.mark.parametrize("size", [1, 2, 777, 70_001])
def test_generator_gives_exact_size(content, size):
    out = desktop.generate(np.random.default_rng(3), size, {"content": content}, None)
    assert out.dtype == np.uint8 and out.shape == (size,)


def _block_kinds(raw: bytes) -> set:
    """The kinds of block in an entry's zstd frames, by the reference's
    parsers: "raw", "rle", or a compressed block's literals section type
    ("lit_raw", "lit_rle", "lit_huffman", "lit_treeless") and whether its
    sequences section is empty ("seq0")."""
    kinds, pos = set(), 0
    while pos < len(raw):
        head = ref_frame.parse_frame_header(raw, pos + 4)
        pos += 4 + head.header_size
        lits = ref_frame.LiteralsState()
        while True:
            bh = raw[pos] | raw[pos + 1] << 8 | raw[pos + 2] << 16
            btype, bsize = (bh >> 1) & 3, bh >> 3
            if btype == 2:
                block = raw[pos + 3:pos + 3 + bsize]
                kinds.add(("lit_raw", "lit_rle", "lit_huffman", "lit_treeless")[block[0] & 3])
                _, p = ref_frame.parse_literals_section(block, 0, lits)
                if ref_seq.parse_nb_sequences(block, p)[0] == 0:
                    kinds.add("seq0")
            else:
                kinds.add({0: "raw", 1: "rle"}[btype])
            pos += 3 + (1 if btype == 1 else bsize)
            if bh & 1:
                break
        pos += 4 if head.has_checksum else 0
    return kinds


#: members of the configuration whose frames, at ``SEED``, hold what the
#: cell brings to the card: 648 and 729 a block of Huffman literals and no
#: sequences (one or two entries of a seed's tree have one), 6 raw
#: literals with sequences, 10 (media) raw blocks only, 1583 a treeless
#: literals section; then sizes from the smallest up to one clipped
SLICE = [648, 729, 6, 10, 1583, 0, 1442, 273, 931, 443, 2030]


@pytest.fixture(scope="module")
def slice_round_trip(cfg):
    """The slice written through the port's Writer and read back through
    ``Reader.read_file`` with the CPU engine installed; each member clipped
    to 256 KiB, plus a 1-byte and a constant file."""
    clipped = {**cfg, "members": [{**m, "bytes": min(m["bytes"], 256 << 10)}
                                  for m in cfg["members"]]}
    # each member from its own stream, as the cell makes it
    files = [(clipped["members"][i]["name"], corpus.member(clipped, SEED, i)) for i in SLICE]
    files += [("d00/one.txt", files[0][1][:1]), ("d00/zeros.bin", bytes(5000))]
    before = codecs.device_setting()
    engine.install("cpu")
    zstd_codec.reset_fallbacks()
    try:
        opts = zp.CompressOptions(zp.CompressionMethod.ZSTD, 3)
        w = zp.Writer.to_heap()
        w.write_archive([(n, d, opts) for n, d in files])
        r = zp.Reader.from_memory(w.buffer)
        reads = {n: r.read_file(n) for n, _ in files}
        raws = {e.filename: r.read_raw_file(e) for e in r.file_entries}
        fallbacks = dict(zstd_codec.FALLBACKS)
    finally:
        codecs.set_device(before)
    return files, reads, raws, fallbacks


def test_slice_reads_equal_content_and_reference(slice_round_trip):
    files, reads, raws, fallbacks = slice_round_trip
    assert fallbacks == {"device_to_host": 0}
    for name, data in files:
        assert reads[name] == data, name
        assert ref_frame.decompress(raws[name]) == data, name


def test_slice_brings_every_frame_kind(slice_round_trip):
    files, _, raws, _ = slice_round_trip
    sizes = {n: len(d) for n, d in files}
    kinds = {n: _block_kinds(raws[n]) for n, _ in files}
    assert sizes["d00/one.txt"] == 1 and kinds["d00/one.txt"] == {"raw"}
    assert "rle" in kinds["d00/zeros.bin"]
    seen = set().union(*kinds.values())
    assert {"raw", "rle", "lit_raw", "lit_huffman", "lit_treeless", "seq0"} <= seen, seen
    # a member whose frames are raw blocks alone, beside tiny ones
    assert any(k == {"raw"} and sizes[n] > (16 << 10) for n, k in kinds.items())
    assert max(sizes.values()) <= 256 << 10
