"""The port's LZ4 compressor and batched extract against the JAX package's
mesh pipeline on one device: frames byte-identical, decoded bytes equal; and
the twins of ``__graft_entry__.entry()`` and ``lz4_jax.compress_block_tpu``."""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from test_kernels import _mix
from zpack_tpu.codecs.lz4 import block as jax_lz4block, frame as jax_lz4frame
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import lz4_jax
from zpack_tpu.parallel import extract as jax_extract
from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh
from zpack_tpu_torch import native
from zpack_tpu_torch.codecs.lz4 import frame as lz4frame
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import lz4_torch, serialize_cases
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor
from zpack_tpu_torch.utils.observe import Metrics

torch.set_num_threads(1)

KINDS = ["mix", "small", "empty", "zeros", "noise"]


def _data(kind: str, B: int) -> bytes:
    return {
        "mix": lambda: _mix(3 * B + 1234, seed=21),
        "small": lambda: _mix(40000, seed=22),
        "empty": lambda: b"",
        "zeros": lambda: b"\0" * (2 * B + 77),
        "noise": lambda: np.random.default_rng(B).integers(0, 256, B + 500, dtype=np.uint8).tobytes(),
    }[kind]()


_MESH = {}


def _jax_frame(data: bytes, B: int) -> bytes:
    mc = _MESH.get(B)
    if mc is None:
        mc = _MESH[B] = MeshCompressor(make_mesh(jax.devices()[:1]), block_size=B)
    return mc.compress(data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [4096, 65536])
def test_device_compressor_matches_mesh(B, kind):
    data = _data(kind, B)
    got = DeviceCompressor("cpu", block_size=B).compress(data)
    assert got == _jax_frame(data, B)
    assert lz4frame.decompress_frame(got) == data
    assert jax_lz4frame.decompress_frame(got) == data


def test_small_blocks_take_the_u16_wire_mode():
    """Windows of 8 KiB or less ship one uint16 per byte, as the JAX step
    does; the serializer takes that format as it comes."""
    data = _data("mix", 4096)
    steps = {B: list(DeviceCompressor("cpu", block_size=B)._steps_raw(data))
             for B in (4096, 8192, 16384)}
    assert [s[0][1] for s in steps.values()] == ["u16", "u16", "pair"]
    lo, mode, host, est = steps[4096][0]
    assert lo == 0 and len(host) == 1 and host[0].dtype == np.uint16
    assert host[0].shape == (-(-len(data) // 4096), 4096)
    mesh_step = next(MeshCompressor(make_mesh(jax.devices()[:1]), block_size=4096)._steps_raw(data))
    assert mesh_step[1] == "u16"
    assert np.array_equal(host[0], mesh_step[2][0][: len(host[0])])


def test_tokenize_est_total_matches_mesh_on_full_steps():
    """The JAX ``est_total`` counts its padding rows; on an input that
    fills its steps (256 blocks of 4 KiB) the two agree, and on a shorter
    one the port's equals the ``_est`` formula over the real rows."""
    full = _mix(256 * 4096, seed=24)
    mc = MeshCompressor(make_mesh(jax.devices()[:1]), block_size=4096)
    dc = DeviceCompressor("cpu", block_size=4096)
    assert mc.blocks_per_device_step == 256
    assert dc.tokenize(full)[3] == mc.tokenize(full)[3]
    short = full[: 5 * 4096 + 99]
    _src, want_mlen, nb, want_est = mc.tokenize(short)
    src, mlen, _nb, est = dc.tokenize(short)
    hit = want_mlen[:nb] >= 4
    assert est == int((4096 - np.where(hit, want_mlen[:nb], 0).sum(1) + 3 * hit.sum(1)).sum())
    assert est != want_est  # the padding rows of zeros match themselves


def test_entry_twin_matches_graft_entry():
    forward, (sample,) = __graft_entry__.entry()
    want = forward(sample)
    port_forward, (port_sample,) = lz4_torch.entry("cpu")
    assert np.array_equal(np.asarray(sample), port_sample.numpy())
    got = port_forward(port_sample)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] >= 4).sum()) > 100


@pytest.mark.parametrize("n_words", [2, 4])
@pytest.mark.parametrize("n", [0, 5, 12, 13, 255, 300, 16384, 20001])
def test_compress_block_twin_matches_compress_block_tpu(n, n_words):
    data = _mix(n, seed=n + 1)
    got = lz4_torch.compress_block(data, "cpu", 2, n_words)
    assert got == lz4_jax.compress_block_tpu(data, 2, n_words)
    assert jax_lz4block.decompress_block(got, n) == data


def test_frames_do_not_depend_on_step_size():
    data = _mix(5 * 4096 + 99, seed=23)
    one = DeviceCompressor("cpu", block_size=4096)
    one.blocks_per_step = 1
    assert one.compress(data) == DeviceCompressor("cpu", block_size=4096).compress(data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [4096, 65536])
def test_extract_matches_jax_on_mesh_frames(B, kind):
    data = _data(kind, B)
    fr = _jax_frame(data, B)
    got = extract.decompress_lz4f_batched(fr, device="cpu")
    assert got == jax_extract.decompress_lz4f_batched(fr) == data


def test_extract_matches_jax_on_checksummed_independent_frames():
    data = _mix(200000, seed=61)
    fr = lz4frame.compress_frame(data, 1, block_indep=True, content_checksum=True)
    assert extract.decompress_lz4f_batched(fr, device="cpu") == data
    assert jax_extract.decompress_lz4f_batched(fr) == data
    corrupt = fr[:-1] + bytes([fr[-1] ^ 1])
    with pytest.raises(DecompressError, match="content checksum"):
        extract.decompress_lz4f_batched(corrupt, device="cpu")


def test_extract_rejects_linked_frames():
    fr = lz4frame.compress_frame(_mix(200000, seed=61), 1, block_indep=False)
    with pytest.raises(JaxDecompressError):
        jax_extract.decompress_lz4f_batched(fr)
    with pytest.raises(DecompressError, match="linked"):
        extract.decompress_lz4f_batched(fr, device="cpu")


def test_device_compressor_requires_native_serializer(monkeypatch):
    monkeypatch.setattr(native, "lz4_serialize_blocks_packed", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native LZ4 serializer"):
        DeviceCompressor("cpu", block_size=4096).compress(b"x" * 10000)


# -- the block serializer's plain version --------------------------------------

def _native_sections(rows: np.ndarray, arrays, mode: str, n: int) -> bytes:
    return native.lz4_serialize_blocks_packed(rows.reshape(-1)[:n].tobytes(), mode, arrays,
                                              rows.shape[1])


def test_serialize_cases_are_named_in_order():
    assert tuple(serialize_cases.cases("pair")) == serialize_cases.NAMES
    assert tuple(serialize_cases.cases("u16")) == serialize_cases.NAMES


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
@pytest.mark.parametrize("name", serialize_cases.NAMES)
def test_serialize_plain_matches_the_native_serializer(name, mode):
    """The plain version's sections are the native serializer's bytes, and
    the CPU's ``serialize_sections`` buffer holds them behind its header."""
    rows, arrays, n = serialize_cases.cases(mode)[name]
    want = _native_sections(rows, arrays, mode, n)
    assert lz4_torch.serialize_plain(rows, arrays, mode, n) == want
    buf = lz4_torch.serialize_sections(torch.from_numpy(rows),
                                       [torch.from_numpy(a) for a in arrays], mode, n)
    assert buf.shape == (lz4_torch.SERIALIZE_HEADER + n + 4 * len(rows),)
    assert bytes(lz4_torch.sections(buf)) == want


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
def test_serialize_plain_block_by_block_equals_the_whole_shard(mode):
    """Shards of one block each (``blocks_per_step = 1``) give the whole
    shard's sections back to back."""
    rows, arrays, n = serialize_cases.cases(mode)["every kind side by side"]
    B = rows.shape[1]
    parts = [lz4_torch.serialize_plain(rows[i:i + 1], [a[i:i + 1] for a in arrays], mode,
                                       min(B, n - i * B)) for i in range(len(rows))]
    assert b"".join(parts) == _native_sections(rows, arrays, mode, n)
    data = rows.reshape(-1)[:n].tobytes()
    one = DeviceCompressor("cpu", block_size=B)
    one.blocks_per_step = 1
    frame = one.compress(data)
    assert frame == DeviceCompressor("cpu", block_size=B).compress(data)
    assert lz4frame.decompress_frame(frame, n) == data


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
def test_serialize_sections_frames_decode(mode):
    """The sections of tokenized data behind a frame header decode to it."""
    rows, arrays, n = serialize_cases.cases(mode)["every kind side by side"]
    body = lz4_torch.serialize_plain(rows, arrays, mode, n)
    frame = lz4frame._header(64 << 10, True, False, None) + body + bytes(4)
    assert lz4frame.decompress_frame(frame, n) == rows.reshape(-1)[:n].tobytes()


def test_sections_raise_where_a_block_overflowed():
    buf = np.zeros(lz4_torch.SERIALIZE_HEADER + 64, dtype=np.uint8)
    buf[:lz4_torch.SERIALIZE_HEADER].view(np.int64)[:] = (10, 0)
    assert len(lz4_torch.sections(buf)) == 10
    buf[:lz4_torch.SERIALIZE_HEADER].view(np.int64)[:] = (10, 2)
    with pytest.raises(RuntimeError, match="2 block"):
        lz4_torch.sections(buf)


def test_serialize_sections_refuses_what_it_cannot_take():
    rows = torch.zeros((2, 4096), dtype=torch.uint8)
    with pytest.raises(ValueError, match="wire modes"):
        lz4_torch.serialize_sections(rows, lz4_torch.tokenize(rows, mode="hash"), "hash", 100)
    pair = lz4_torch.tokenize(rows)
    with pytest.raises(ValueError, match="do not fit"):
        lz4_torch.serialize_sections(rows, pair, "pair", 8193)
    wide = torch.zeros((1, 16384), dtype=torch.uint8)
    with pytest.raises(ValueError, match="13 bits"):
        lz4_torch.serialize_sections(wide, lz4_torch.tokenize(wide), "u16", 100)


def test_cpu_route_counts_the_host_serializer_a_shard(monkeypatch):
    """On the CPU each shard goes through the native serializer, counted
    once under ``torch.serialize`` with its bytes; no shard counts the
    card's route."""
    m = Metrics()
    monkeypatch.setattr("zpack_tpu_torch.parallel.pipeline.metrics", m)
    data = _data("mix", 4096)
    dc = DeviceCompressor("cpu", block_size=4096)
    dc.blocks_per_step = 2
    assert lz4frame.decompress_frame(dc.compress(data)) == data
    snap = m.snapshot()
    shards = -(-len(data) // (2 * 4096))
    assert snap["lz4.serialize.host"]["calls"] == shards
    assert snap["lz4.serialize.host"]["bytes"] == len(data)
    assert snap["lz4.serialize.host"]["parents"] == {"torch.serialize": shards}
    assert "lz4.serialize.device" not in snap


# -- LZ4's high-compression levels: the HC parse and the match settings --------

def _hc_case(mode: str, name: str):
    return (serialize_cases.cases(mode) | serialize_cases.hc_cases(mode))[name]


def _reference_decode(frame: bytes) -> bytes:
    """The frame's blocks decoded by the benchmark's own reference."""
    from zbench.reference import lz4 as ref_lz4

    frames, problems = ref_lz4.walk(frame)
    assert problems == []
    return b"".join(ref_lz4.decode_block(frame[b.start:b.start + b.size]) if b.compressed
                    else frame[b.start:b.start + b.size] for f in frames for b in f.blocks)


def test_hc_cases_are_named_in_order():
    assert tuple(serialize_cases.hc_cases("pair")) == serialize_cases.HC_NAMES
    assert tuple(serialize_cases.hc_cases("u16")) == serialize_cases.HC_NAMES


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
@pytest.mark.parametrize("name", serialize_cases.NAMES + serialize_cases.HC_NAMES)
def test_serialize_plain_hc_matches_the_native_hc_serializer(name, mode):
    """The HC parse's plain version is the native HC serializer's bytes, on
    every case and on the HC levels' tables; the CPU's buffer holds them,
    and behind a frame header they decode to the data on the host decoder
    and on the benchmark's reference, where the tables are true."""
    rows, arrays, n = _hc_case(mode, name)
    data = rows.reshape(-1)[:n].tobytes()
    want = native.lz4_serialize_blocks_hc(data, mode, arrays, rows.shape[1])
    assert lz4_torch.serialize_plain(rows, arrays, mode, n, "hc") == want
    buf = lz4_torch.serialize_sections(torch.from_numpy(rows),
                                       [torch.from_numpy(a) for a in arrays], mode, n, "hc")
    assert bytes(lz4_torch.sections(buf)) == want
    if "past the bytes" in name:  # tables the bytes do not bear out decode to other bytes
        return
    frame = lz4frame._header(64 << 10, True, False, None) + want + bytes(4)
    assert lz4frame.decompress_frame(frame, n) == data
    assert _reference_decode(frame) == data


@pytest.mark.parametrize("mode", lz4_torch.SERIALIZE_MODES)
def test_hc_parse_takes_literal_steps(mode):
    """Where a longer match starts one or two bytes on, the HC parse
    emits literals to take it: fewer bytes than the greedy parse on the
    planted repeats and on text, the same where no such match exists."""
    for name in ("planted repeats at depth 32", "lengths about the lazy cap", "text at depth 8"):
        rows, arrays, n = serialize_cases.hc_cases(mode)[name]
        hc = lz4_torch.serialize_plain(rows, arrays, mode, n, "hc")
        assert len(hc) < len(lz4_torch.serialize_plain(rows, arrays, mode, n)), name
    rows, arrays, n = serialize_cases.cases(mode)["noise: every block raw"]
    assert (lz4_torch.serialize_plain(rows, arrays, mode, n, "hc")
            == lz4_torch.serialize_plain(rows, arrays, mode, n))


def test_serialize_sections_refuses_an_unknown_parse():
    rows = torch.zeros((1, 4096), dtype=torch.uint8)
    with pytest.raises(ValueError, match="parses"):
        lz4_torch.serialize_sections(rows, lz4_torch.tokenize(rows), "pair", 100, "optimal")


def test_hc_constants_are_the_pythons():
    """The HC parse's lazy cap is stated once, ``lz4_torch.HC_LAZY_CAP``:
    the serializer kernel's (its scan's exact reach) and the native HC
    serializer's copies agree with it; the match finder's zero pad covers
    the longest comparison, ``CAPJ_MAX``, and the 8 bytes its loads read
    past it."""
    pkg = pathlib.Path(lz4_torch.__file__).resolve().parent.parent
    ser = (pkg / "csrc" / "lz4_serialize.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", ser)}
    assert consts["kMinMatch"] + consts["kScanExtend"] == lz4_torch.HC_LAZY_CAP
    assert "constexpr int kLazyCap = kMinMatch + kScanExtend;" in ser
    hc = (pkg.parent / "native" / "lz4_hc.cpp").read_text()
    assert int(re.search(r"constexpr size_t kLazyCap = (\d+);", hc).group(1)) == \
        lz4_torch.HC_LAZY_CAP
    tok = (pkg / "csrc" / "lz4_tokenize.cu").read_text()
    assert int(re.search(r"constexpr int kPad = (\d+);", tok).group(1)) > lz4_torch.CAPJ_MAX + 7


@pytest.mark.parametrize("level,depth", [(1, 2), (2, 2), (3, 8), (4, 8), (5, 16), (6, 32),
                                         (7, 64), (9, 64), (12, 64)])
def test_lz4_match_settings_follow_the_level(level, depth):
    """Levels 1 and 2: the JAX engine's depth 2, comparison 8, greedy parse.
    HC levels: LZ4HC's attempts 1 << (level - 1), at least 8 and at most
    the cap, comparisons as long as the wire format holds, the HC parse.
    ``tokenize`` and ``compress_zstd`` keep the JAX engine's depth."""
    dc = DeviceCompressor("cpu", level)
    hc = level >= 3
    assert dc.parse == ("hc" if hc else "greedy")
    assert dc._lz4_match("pair") == (depth, 32 if hc else lz4_torch.CAPJ)
    assert dc._lz4_match("u16") == (depth, 10 if hc else lz4_torch.CAPJ)
    assert dc.depth == (8 if hc else 2)


@pytest.mark.parametrize("level", [3, 9, 12])
@pytest.mark.parametrize("B", [4096, 65536])
def test_device_compressor_hc_frames_decode(B, level):
    """HC-level frames decode to the content on the host decoder, the JAX
    package's and the benchmark's reference, and store fewer bytes than
    level 1's."""
    data = _data("mix", B) + _mix(B + 333, seed=27) + _data("zeros", B)
    frame = DeviceCompressor("cpu", level, block_size=B).compress(data)
    assert lz4frame.decompress_frame(frame) == data
    assert jax_lz4frame.decompress_frame(frame) == data
    assert _reference_decode(frame) == data
    assert len(frame) < len(DeviceCompressor("cpu", 1, block_size=B).compress(data))


@pytest.mark.parametrize("B", [4096, 65536])
def test_level_2_keeps_the_mesh_bytes(B):
    """Level 2 is a fast level: the JAX engine's frame, as level 1's."""
    data = _data("mix", B)
    assert DeviceCompressor("cpu", 2, block_size=B).compress(data) == _jax_frame(data, B)


def test_device_compressor_hc_requires_the_native_hc_serializer(monkeypatch):
    monkeypatch.setattr(native, "lz4_serialize_blocks_hc", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="native LZ4 serializer"):
        DeviceCompressor("cpu", 9, block_size=4096).compress(b"x" * 10000)
