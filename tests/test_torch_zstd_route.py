"""The zstd read's device route on the CPU (``decompress_zstd_device``, with
the assembly's plain versions) against the JAX function it matches: the same
bytes on raw-only, RLE, literal-only, multi-frame and tree-sized entries,
frames with and without a declared size and with a wrong one; the same first
DecompressError on every input of the native walk's corruption sweeps; the
replay's RuntimeError after every DecompressError; and, through
``Reader.read_file``, one ``*.wait`` span a read, two and a
``torch.zstd_resize`` count where a frame declares no size."""

import numpy as np
import pytest
import torch
import zstandard

from test_torch_zstd_walk_native import _corrupted
from zpack_tpu import native as jax_native
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.parallel import extract as jax_extract
from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer, codecs, engine
from zpack_tpu_torch.codecs import zstd as port_zstd
from zpack_tpu_torch.codecs.zstd import frame as zframe
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import assemble_torch, lz4_torch
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.utils.observe import metrics

torch.set_num_threads(1)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except (DecompressError, JaxDecompressError) as e:
        return f"DecompressError: {e}"


def _port(data, max_out=None):
    return extract.decompress_zstd_device(data, max_out, device="cpu")


def _jax(data, max_out=None):
    return jax_extract.decompress_zstd_device(data, max_out)


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8)) for _ in range(200)]
    return b" ".join(words[i] for i in rng.integers(0, 200, n // 4))[:n]


def _no_size(b: bytes) -> bytes:
    return zstandard.ZstdCompressor(level=3, write_content_size=False).compress(b)


def _wrong_size(frame: bytes) -> bytes:
    """The frame with its declared size one more (a 2-byte size field)."""
    assert frame[4] & 0xE0 == 0x60  # single segment, 2-byte size
    size = int.from_bytes(frame[5:7], "little") + 1
    return frame[:5] + size.to_bytes(2, "little") + frame[7:]


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    noise = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    text = _text(40_000, 1)
    return {
        "raw only": (jax_native.zstd_compress(noise, 3), noise),
        "rle": (jax_native.zstd_compress(b"\x07" * 300_000, 3), b"\x07" * 300_000),
        "literals alone": (jax_native.zstd_compress(noise[:3000], 3), noise[:3000]),
        "tiny": (jax_native.zstd_compress(b"ab", 3), b"ab"),
        "one byte": (jax_native.zstd_compress(b"\x00", 3), b"\x00"),
        "empty": (jax_native.zstd_compress(b"", 3), b""),
        "text": (jax_native.zstd_compress(text, 3), text),
        "multi-frame": (b"".join(jax_native.zstd_compress(text[i:i + 9_000], 3)
                                 for i in range(0, 40_000, 9_000)), text),
        "frames of every kind": (
            b"".join([jax_native.zstd_compress(noise[:9000], 3), _no_size(text[:20_000]),
                      jax_native.zstd_compress(b"z" * 5000, 3),
                      zstandard.ZstdCompressor(level=19, write_checksum=True).compress(text)]),
            noise[:9000] + text[:20_000] + b"z" * 5000 + text),
        "no declared size": (_no_size(text), text),
        "declared size wrong": (_wrong_size(jax_native.zstd_compress(text[:30_000], 3)),
                                text[:30_000]),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_route_returns_the_bytes_jax_returns(name):
    data, want = INPUTS[name]
    assert _port(data) == want == _jax(data)
    assert _port(data, len(want)) == want
    if want:
        assert _outcome(_port, data, len(want) - 1) == _outcome(_jax, data, len(want) - 1) \
            == "DecompressError: zstd output exceeds expected size"


#: the sweeps' inputs go in this many cases: each input costs about a
#: second of the CPU's plain sequence decode and one of JAX's
FLIP_GROUPS = 16


@pytest.mark.parametrize("group", range(FLIP_GROUPS))
def test_flip_sweeps_raise_what_jax_raises(group):
    """The 16 flips of the extract test and the 288 of the native walk's
    test (both sweeps of ``_corrupted``), the group'th of every
    ``FLIP_GROUPS``: each raises what JAX raises, or returns its bytes."""
    blob, flips = _corrupted()
    for bad in flips[group::FLIP_GROUPS]:
        assert _outcome(_port, bad, len(blob)) == _outcome(_jax, bad, len(blob))


def _sentinel_zeroed(frame: bytes) -> bytes:
    """``frame`` (one frame) with the last byte of its first block with
    sequences zeroed: that block's sequence bitstream loses its sentinel,
    so the native walk refuses the entry and the Python walk's plan carries
    the FSE batch's error."""
    pos = 4 + zframe.parse_frame_header(frame, 4).header_size
    for b in extract.walk_zstd(frame).frames[0][1]:
        bsize = (frame[pos] | frame[pos + 1] << 8 | frame[pos + 2] << 16) >> 3
        pos += 3 + (1 if b.btype == zframe.BLOCK_RLE else bsize)
        if b.slot is not None:
            break
    bad = bytearray(frame)
    bad[pos - 1] = 0
    return bytes(bad)


def test_a_plan_with_a_pending_error_raises_it_after_the_huffman_check():
    data, want = INPUTS["text"]
    bad = _sentinel_zeroed(data)
    assert extract.zstd_plan(bad).error is not None
    assert _outcome(_port, bad, len(want)) == _outcome(_jax, bad, len(want)) == \
        "DecompressError: corrupt backward bitstream (no sentinel)"


def test_replay_error_comes_after_every_decompress_error(monkeypatch):
    data, want = INPUTS["text"]
    enqueue = lz4_torch.replay_enqueue

    def failing(*args, **kwargs):
        rows, state = enqueue(*args, **kwargs)
        state[0] = 1
        return rows, state

    monkeypatch.setattr(lz4_torch, "replay_enqueue", failing)
    with pytest.raises(RuntimeError) as e:
        _port(data)
    assert str(e.value) == lz4_torch.REPLAY_UNRESOLVED
    # a DecompressError the card recorded comes first
    assert _outcome(_port, data, len(want) - 1) == \
        "DecompressError: zstd output exceeds expected size"


def _read_counts(entries, compress=None, monkeypatch=None) -> list:
    """``(waits, resizes)`` of each read of ``entries`` through
    ``Reader.read_file``, from the registry."""
    before = codecs.device_setting()
    engine.install("cpu")
    try:
        if compress is not None:
            monkeypatch.setattr(port_zstd.ZstdCodec, "compress", compress)
        w = Writer.to_heap()
        w.write_archive(entries)
        if compress is not None:
            monkeypatch.undo()
        r = Reader.from_memory(w.buffer)
        out = []
        for name, data, _ in entries:
            metrics.reset()
            assert r.read_file(name) == data
            snap = metrics.snapshot()
            assert snap["zstd.decompress"]["calls"] == 1
            out.append((sum(v["calls"] for k, v in snap.items() if k.endswith(".wait")),
                        snap.get("torch.zstd_resize", {}).get("calls", 0)))
        return out
    finally:
        codecs.set_device(before)


def _entries():
    zstd = CompressOptions(CompressionMethod.ZSTD, 3)
    rng = np.random.default_rng(4)
    return [("text", _text(60_000, 2), zstd), ("small", b"hello zstd " * 30, zstd),
            ("raw", rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(), zstd),
            ("rle", b"\x00" * 40_000, zstd)]


def test_a_read_waits_on_the_device_once():
    assert _read_counts(_entries()) == [(1, 0)] * 4


def test_a_frame_without_its_size_waits_twice_and_counts_a_resize(monkeypatch):
    counts = _read_counts(
        _entries(), lambda self, data, level=3, **k: _no_size(data), monkeypatch)
    assert counts == [(2, 1)] * 4


def test_a_wrong_declared_size_replays_again():
    data, want = INPUTS["declared size wrong"]
    metrics.reset()
    assert _port(data) == want
    snap = metrics.snapshot()
    assert snap["torch.replay.wait"]["calls"] == 2
    assert snap["torch.zstd_resize"]["calls"] == 1
    assert sum(v["calls"] for k, v in snap.items() if k.endswith(".wait")) == 2


def test_predicted_sizes_only_where_every_frame_declares_one_its_blocks_hold():
    data, want = INPUTS["text"]
    plan = extract.zstd_plan(data)
    assert extract.predicted_sizes(plan, None).tolist() == [len(want)]
    assert extract.predicted_sizes(plan, len(want) - 1) is None
    assert extract.predicted_sizes(extract.zstd_plan(INPUTS["no declared size"][0]), None) is None
    big = plan._replace(frame_size=plan.frame_size + assemble_torch.MAX_BLOCK * 64)
    assert extract.predicted_sizes(big, None) is None
