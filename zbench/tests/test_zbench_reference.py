"""The reference reads the archives the port writes, at a small size on
the CPU, and finds what is wrong with broken ones."""

import struct

import numpy as np
import pytest

import zpack_tpu_torch as zp
from zpack_tpu_torch import engine
from zpack_tpu_torch.codecs.xxh3 import xxh3_64 as port_xxh3

from zbench.reference import archive as zarc
from zbench.reference import check, lz4 as rlz4
from zbench.reference.xxhash import xxh3_64


@pytest.fixture(scope="module")
def entries():
    rng = np.random.default_rng(4)
    text = (rng.integers(97, 101, 300_000, dtype=np.uint8)).tobytes()
    return [("a", text[:150_000]), ("b/c", text[50_000:250_000]), ("small", text[:3_000]),
            ("noise", rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()), ("empty", b"")]


def _archive(entries, method, level):
    engine.install("cpu")
    try:
        w = zp.Writer.to_heap()
        opts = zp.CompressOptions(zp.CompressionMethod(method), level)
        w.write_archive([(n, d, opts) for n, d in entries])
        return w.buffer
    finally:
        engine.uninstall()


def _check(buf, entries, method, samples=1000):
    contents = dict(entries)
    return check.check_archives([buf], [n for n, _ in entries], contents,
                                check.reference_hashes(contents), method,
                                np.random.default_rng(0), samples)


@pytest.mark.parametrize("method,level", [(2, 1), (1, 3)])
def test_reference_decodes_port_archives(entries, method, level):
    buf = _archive(entries, method, level)
    wrong, decoded = _check(buf, entries, method)
    assert wrong == {"records_wrong": 0, "hashes_wrong": 0, "frames_wrong": 0, "blocks_wrong": 0}
    assert decoded >= (6 if method == 2 else 4)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 128, 129, 240, 241, 1024, 1025, 70_001, 300_000])
def test_reference_xxh3_equals_port(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert xxh3_64(data) == port_xxh3(data)


def test_reference_finds_broken_archives(entries):
    buf = _archive(entries, 2, 1)
    parsed, faults = zarc.parse(buf)
    assert not faults
    e = parsed[0]
    frames, _ = rlz4.walk(buf[e.offset:e.offset + e.comp_size])
    blk = next(b for b in frames[0].blocks if b.compressed)
    at = e.offset + blk.start + blk.size // 2

    # a byte altered inside a compressed block: its decode differs
    bad = bytearray(buf)
    bad[at] ^= 0x55
    assert _check(bytes(bad), entries, 2)[0]["blocks_wrong"] >= 1
    # a CDR hash altered
    cdr = struct.unpack_from("<Q", buf, len(buf) - 8)[0]
    bad = bytearray(buf)
    pos = cdr + 20 + 2 + len(e.name) + 24
    bad[pos] ^= 1
    assert _check(bytes(bad), entries, 2)[0]["hashes_wrong"] == 1
    # the EOCDR signature
    bad = bytearray(buf)
    bad[-12] ^= 1
    assert _check(bytes(bad), entries, 2)[0]["records_wrong"] == 1
    # an entry left out
    assert _check(_archive(entries[:2] + entries[3:], 2, 1), entries, 2)[0]["records_wrong"] == 1
    # a frame with a block dropped: the count no longer fits the size
    bad = bytearray(buf)
    word = struct.unpack_from("<I", buf, e.offset + blk.start - 4)[0]
    assert word & 0x7FFFFFFF == blk.size
    del bad[e.offset + blk.start - 4:e.offset + blk.start + blk.size]
    parsed_bad = _check(bytes(bad), entries, 2)[0]
    assert parsed_bad["records_wrong"] == 1 or parsed_bad["frames_wrong"] >= 1


def test_reads_compared_byte_for_byte(entries):
    contents = dict(entries)
    good = [("a", contents["a"]), ("b/c", contents["b/c"])]
    bad = [("a", contents["a"][:-1] + b"\0")]
    assert check.check_reads(good, [("a", 150_000)], contents) == {
        "reads_wrong": 0, "read_sizes_wrong": 0}
    assert check.check_reads(bad, [("a", 149_999)], contents) == {
        "reads_wrong": 1, "read_sizes_wrong": 1}
