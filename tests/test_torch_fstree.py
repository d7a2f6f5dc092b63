"""The desktop file tree configurations (``zbench/configs/fstree/``, at
zstd-3 and at LZ4-1) through the port on the CPU: their sizes are the
stated draw, their generator repeats from the seed; a slice of the members
round-trips through the port's ``Writer`` and ``Reader.read_file`` on the
zstd device route with no step down, equal to the content and to the
benchmark's plain zstd decoder; and entries at the edges of the LZ4 routes
round-trip on the route their size names, equal to the benchmark's plain
LZ4 decoder."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import zpack_tpu_torch as zp
from zbench import corpus
from zbench.gen import desktop
from zbench.reference import archive as ref_archive
from zbench.reference import lz4 as ref_lz4
from zbench.reference.xxhash import xxh3_64 as ref_xxh3
from zbench.reference.zstd import frame as ref_frame
from zbench.reference.zstd import seq as ref_seq
from zpack_tpu_torch import codecs, engine
from zpack_tpu_torch.codecs import lz4 as lz4_codec
from zpack_tpu_torch.codecs import zstd as zstd_codec
from zpack_tpu_torch.utils.observe import metrics

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "zbench/configs/fstree"
#: each configuration's method and level
METHODS = {"fstree-zstd3": (1, 3), "fstree-lz4": (2, 1)}
SEED = 2**40 + 5


def _load(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(scope="module", params=sorted(METHODS))
def cfg(request):
    return _load(request.param)


def test_sizes_are_the_stated_draw(cfg):
    draw = np.random.default_rng(20090224).normal(9.48, 2.46, 2048)
    sizes = np.maximum(1, np.rint(np.exp(draw))).astype(np.int64)
    assert [m["bytes"] for m in cfg["members"]] == sizes.tolist()
    assert sum(m["bytes"] for m in cfg["members"]) == 385_241_602
    assert cfg["sizes"]["total_bytes"] == 385_241_602
    assert cfg["sizes"]["median_bytes"] == 12_964 == int(np.median(sizes))
    assert cfg["file_count"] == len(cfg["members"]) == 2048
    assert cfg["reduced"] == ["file_count"]
    assert (cfg["method"], cfg["level"]) == METHODS[cfg["name"]]


def test_trees_share_their_members():
    """The LZ4 tree is the zstd tree's files at another method and level."""
    zstd, lz4 = _load("fstree-zstd3"), _load("fstree-lz4")
    assert lz4["members"] == zstd["members"]
    for key in ("file_count", "sizes", "kinds", "assumed", "reduced", "guarantees"):
        assert lz4[key] == zstd[key], key


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
def slice_round_trip():
    """The slice written through the port's Writer and read back through
    ``Reader.read_file`` with the CPU engine installed; each member clipped
    to 256 KiB, plus a 1-byte and a constant file."""
    cfg = _load("fstree-zstd3")
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


# -- the LZ4 tree's routes ------------------------------------------------------

K = 1 << 10
#: entries at the edges of the LZ4 routes, by the route their size names:
#: under ``DEVICE_MIN`` (64 KiB) the host encoder's one linked block, from
#: it up the card's frame of independent 64 KiB blocks (the last of one
#: byte at 64 KiB + 1 and 128 KiB + 1), and a media entry of three random
#: blocks, each stored raw
LZ4_EDGES = {
    "d00/one.txt": (1, "text", "host"),
    "d00/under.txt": (64 * K - 1, "text", "host"),
    "d00/at.txt": (64 * K, "markup", "device"),
    "d00/over.dll": (64 * K + 1, "binary", "device"),
    "d00/two.csv": (128 * K + 1, "records", "device"),
    "d00/media.jpg": (192 * K, "media", "device"),
}
ROUTES = ("lz4.compress.device", "lz4.compress.host", "lz4.decompress.device",
          "lz4.decompress.host")


def _route_counts() -> dict:
    snap = metrics.snapshot()
    return {n: (snap[n]["calls"], snap[n]["bytes"]) if n in snap else (0, 0) for n in ROUTES}


def _ref_lz4(raw: bytes) -> tuple[bytes, set]:
    """The entry's content by the benchmark's plain LZ4 decoder, and
    whether its blocks are linked, stored raw or compressed."""
    frames, faults = ref_lz4.walk(raw)
    assert not faults, faults
    out, kinds = bytearray(), set()
    for f in frames:
        for b in f.blocks:
            kinds |= {"linked" if b.linked else "independent",
                      "compressed" if b.compressed else "raw"}
            payload = raw[b.start:b.start + b.size]
            prefix = bytes(out[-64 * K:]) if b.linked else b""
            out += ref_lz4.decode_block(payload, prefix) if b.compressed else payload
    return bytes(out), kinds


@pytest.fixture(scope="module")
def lz4_edges():
    """Each edge entry written alone through the port's Writer at LZ4-1
    with the CPU engine installed and read back through
    ``Reader.read_file``: its archive, its read and the route counts each
    step added."""
    rng = np.random.default_rng(SEED)
    before = codecs.device_setting()
    engine.install("cpu")
    got = {}
    try:
        opts = zp.CompressOptions(zp.CompressionMethod.LZ4, 1)
        for name, (size, content, _) in LZ4_EDGES.items():
            data = desktop.generate(rng, size, {"content": content}, None).tobytes()
            c0 = _route_counts()
            w = zp.Writer.to_heap()
            w.write_archive([(name, data, opts)])
            c1 = _route_counts()
            out = zp.Reader.from_memory(w.buffer).read_file(name)
            c2 = _route_counts()
            diff = {n: (c1[n][0] - c0[n][0], c1[n][1] - c0[n][1]) if ".compress." in n
                    else (c2[n][0] - c1[n][0], c2[n][1] - c1[n][1]) for n in ROUTES}
            got[name] = data, w.buffer, out, diff
    finally:
        codecs.set_device(before)
    return got


@pytest.mark.parametrize("name", list(LZ4_EDGES))
def test_lz4_edge_reads_equal_content_and_reference(lz4_edges, name):
    data, archive, out, _ = lz4_edges[name]
    assert out == data
    entries, faults = ref_archive.parse(archive)
    assert not faults and [e.name for e in entries] == [name]
    e = entries[0]
    assert (e.method, e.uncomp_size, e.hash) == (2, len(data), ref_xxh3(data))
    content, kinds = _ref_lz4(archive[e.offset:e.offset + e.comp_size])
    assert content == data
    # the host encoder links its blocks; the card's frame has them independent
    size, content_kind, route = LZ4_EDGES[name]
    assert ("linked" if route == "host" else "independent") in kinds
    if content_kind == "media":
        assert kinds == {"independent", "raw"}


@pytest.mark.parametrize("name", list(LZ4_EDGES))
def test_lz4_edge_counts_the_route_its_size_names(lz4_edges, name):
    data, _, _, diff = lz4_edges[name]
    route = LZ4_EDGES[name][2]
    assert route == ("device" if len(data) >= lz4_codec.DEVICE_MIN else "host")
    want = {n: (1, len(data)) if n.endswith(route) else (0, 0) for n in ROUTES}
    assert diff == want
