"""The native zstd walk (``native/zstd_walk.cpp`` through
``native.ZstdWalk``) against the Python walk: on every input both accept,
the plan ``decompress_zstd_device`` runs on, and the Huffman and FSE
batches in it, equal what ``walk_zstd``, ``_literal_layout`` and the two
``build_decode_batch``s make, array for array (every row and run indexes
the plan's ``source``, the entry on the native walk and a copy of the
streams on the Python one: their bytes are compared); on corrupted
inputs the native walk accepts exactly what the Python walk and the
builders accept; without the walk in the library, or where it rejects, the
Python walk runs and the result is the JAX function's."""

import numpy as np
import pytest
import torch
import zstandard

from test_kernels import _seq_heavy_corpora
from test_torch_zstd_extract import _COMPRESSORS, _corpora, _outcome
from zpack_tpu.codecs.zstd import encode as zenc
from zpack_tpu.parallel import extract as jax_extract
from zpack_tpu_torch import native
from zpack_tpu_torch.codecs.zstd import seq as zseq
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import assemble_cases
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.utils.observe import metrics

torch.set_num_threads(1)

LIB = native.zstd_walk_lib()


def test_the_ports_library_holds_the_walk():
    assert LIB is not None
    assert "zstd_walk.cpp" in [s.name for s in native._SRCS]


def _python_accepts(data: bytes):
    """The Python plan, or None where the walk or a builder raises."""
    try:
        plan = extract._python_plan(data)
    except DecompressError:
        return None
    return None if plan.error is not None else plan


def _native_accepts(data: bytes):
    return extract._native_plan(LIB, data)


def _row_bytes(plan, batch: dict) -> list[bytes]:
    """Each row's bytes of the plan's source."""
    return [plan.source[a:a + n].tobytes() for a, n in batch["rows"][:, :2].tolist()]


def _run_bytes(source: np.ndarray, runs: np.ndarray) -> list[bytes]:
    """Each run's bytes: ``source[src + k * step]`` for ``k`` below its
    length."""
    return [source[src + np.arange(n) * step].tobytes() for n, _, src, step in runs.tolist()]


def _assert_same(data: bytes) -> None:
    pp, np_ = _python_accepts(data), _native_accepts(data)
    assert pp is not None and np_ is not None
    assert np_.error is None and pp.error is None
    assert np_.source.dtype == pp.source.dtype == np.uint8
    assert np_.source.tobytes() == data  # the entry, as it is
    for field in ("frame_chk", "lit_row"):
        assert getattr(np_, field) == getattr(pp, field), field
    for field in ("blocks", "frame_size"):
        a, b = getattr(np_, field), getattr(pp, field)
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b), field
    # the runs: the same lengths and destinations, and the same bytes of
    # each plan's source
    assert np_.runs.dtype == pp.runs.dtype == np.int64
    assert np.array_equal(np_.runs[:, :2], pp.runs[:, :2])
    assert _run_bytes(np_.source, np_.runs) == _run_bytes(pp.source, pp.runs)
    ph, nh, pf, nf = pp.huffman, np_.huffman, pp.sequences, np_.sequences
    assert (ph is None) == (nh is None) and (pf is None) == (nf is None)
    if ph is not None:
        assert nh.keys() == ph.keys()
        assert np.array_equal(nh["rows"][:, 1:], ph["rows"][:, 1:])
        assert _row_bytes(np_, nh) == _row_bytes(pp, ph)
        assert nh["tables"].dtype == ph["tables"].dtype
        assert np.array_equal(nh["tables"], ph["tables"])
        assert nh["widest"] == ph["widest"]
    if pf is not None:
        assert nf.keys() == pf.keys()
        assert np.array_equal(nf["rows"][:, 1:], pf["rows"][:, 1:])
        assert _row_bytes(np_, nf) == _row_bytes(pp, pf)
        for plan in (np_, pp):  # ascending, as the mesh path needs
            assert np.all(np.diff(plan.sequences["rows"][:, 0]) > 0)
        for k in ("seq_off", "al", "tables"):
            assert nf[k].dtype == pf[k].dtype and np.array_equal(nf[k], pf[k]), k


def _features(data: bytes) -> set:
    """What the entry's walk reaches: block types, literal sections (raw,
    RLE, 1- and 4-stream Huffman, treeless), FSE table modes by kind,
    skippable frames and checksums."""
    seen = set()
    with native.ZstdWalk(LIB, data) as nw:
        lits = nw.literals()
    pos = 0
    while pos < len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic != 0xFD2FB528:
            seen.add("skippable")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
        else:
            break
    if (lits["frame_chk"] >= 0).any():
        seen.add("checksum")
    for frame, off, size, lits_end, _, btype in lits["blocks"].tolist():
        seen.add(("block", btype))
        if btype != 2:
            continue
        b0 = data[off]
        ltype, sf = b0 & 3, (b0 >> 2) & 3
        seen.add(("literals", ("raw", "rle", "huf", "treeless")[ltype],
                  0 if ltype < 2 else 1 if sf == 0 else 4))
        payload = data[off:off + size]
        nb, p = zseq.parse_nb_sequences(payload, lits_end)
        if nb:
            seen |= {("mode", kind, (payload[p] >> s) & 3)
                     for kind, s in (("ll", 6), ("of", 4), ("ml", 2))}
    return seen


def _rle_literals_frame() -> bytes:
    """A frame of one compressed block: 20 literals as an RLE section, no
    sequence."""
    block = bytes([1 | 20 << 3]) + b"x" + b"\x00"
    return (b"\x28\xb5\x2f\xfd" + bytes([0x20, 20])
            + (1 | 2 << 1 | len(block) << 3).to_bytes(3, "little") + block)


def _concatenated() -> bytes:
    """Frames of every corpus back to back, with the repo's own encoder's
    raw and RLE blocks, an empty frame, a checksummed frame, tiny frames
    whose literals make one stream, an RLE literals section, a frame of
    windows of one random buffer (its match-length tables repeat), and
    skippable frames between."""
    blobs = list(_corpora().values())
    rng = np.random.default_rng(8)
    raw = bytes(rng.integers(0, 256, 30000).astype(np.uint8))
    words = blobs[0]
    base = rng.integers(0, 256, 4096).astype(np.uint8).tobytes()
    windows = b"".join(base[i * 97 % 3000:i * 97 % 3000 + 200] + b"QQQ" for i in range(2000))
    parts = [b"\x50\x2a\x4d\x18" + (3).to_bytes(4, "little") + b"abc"]
    parts += [zstandard.ZstdCompressor(level=3).compress(b) for b in blobs[1:]]
    parts += [zenc.compress(b"\x00" * 50000, 3), zenc.compress(raw, 3),
              zstandard.ZstdCompressor(level=3).compress(b""),
              zstandard.ZstdCompressor(level=5, write_checksum=True).compress(words[:60000]),
              zstandard.ZstdCompressor(level=3).compress(words[1000:1200]),
              zstandard.ZstdCompressor(level=19).compress(words[5000:5900]),
              _rle_literals_frame(), zstandard.ZstdCompressor(level=9).compress(windows),
              b"\x5f\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"skip!"]
    return b"".join(parts)


def _inputs() -> dict:
    out = {f"{corpus}-{comp}": fn(blob) for corpus, blob in _corpora().items()
           for comp, fn in _COMPRESSORS.items()}
    out["concatenated"] = _concatenated()
    out["empty"] = b""
    return out


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_native_batches_equal_the_python_walks(name):
    _assert_same(_inputs()[name])


def test_the_inputs_reach_every_block_literal_and_table_kind():
    seen = set()
    for data in _inputs().values():
        seen |= _features(data)
    want = {("block", t) for t in (0, 1, 2)} | {"skippable", "checksum"} | {
        ("literals", "raw", 0), ("literals", "rle", 0), ("literals", "huf", 1),
        ("literals", "huf", 4), ("literals", "treeless", 1), ("literals", "treeless", 4)} | {
        ("mode", kind, m) for kind in ("ll", "of", "ml") for m in (0, 1, 2, 3)}
    assert want <= seen, sorted(want - seen, key=str)


def test_fse_table_modes_of_the_sequence_corpora():
    """Across ``test_fse_decode_saw_every_table_mode``'s frames, every mode
    of every kind that those frames reach gives the same batches."""
    seen = set()
    for fn in _COMPRESSORS.values():
        for _, blob in _seq_heavy_corpora():
            data = fn(blob)
            _assert_same(data)
            seen |= {f[2] for f in _features(data) if f[0] == "mode"}
    assert seen == {0, 1, 2, 3}


def _corrupted():
    """``test_corruption_sweep_raises_where_jax_raises``'s frame with one
    byte flipped at 16 positions, and with three other masks at 32
    positions and at each of the first 64 bytes (the frame, block and
    literals headers and the Huffman tree)."""
    blob = _corpora()["words"][:30000]
    return blob, assemble_cases.flips(zstandard.ZstdCompressor(level=3).compress(blob))


def test_corrupted_inputs_accepted_exactly_where_python_accepts():
    _, inputs = _corrupted()
    accepted = rejected = 0
    for bad in inputs:
        py = _python_accepts(bad)
        nat = _native_accepts(bad)
        assert (py is None) == (nat is None)
        if py is None:
            rejected += 1
        else:
            _assert_same(bad)
            accepted += 1
    assert accepted >= 10 and rejected >= 10


def _walk_calls() -> dict:
    """Calls of the walk's spans, and of the native one under the walk."""
    snap = metrics.snapshot()
    calls = {k: snap.get(k, {}).get("calls", 0)
             for k in ("torch.zstd_walk", "torch.zstd_walk.native", "torch.zstd_walk.literals")}
    calls["native under the walk"] = snap.get("torch.zstd_walk.native", {}).get(
        "parents", {}).get("torch.zstd_walk", 0)
    return calls


def test_native_walk_opens_its_span_under_the_walk():
    blob = _corpora()["words"][:50000]
    frame = zstandard.ZstdCompressor(level=3).compress(blob)
    before = _walk_calls()
    assert extract.decompress_zstd_device(frame, len(blob), device="cpu") == blob
    after = _walk_calls()
    assert {k: after[k] - before[k] for k in after} == {
        "torch.zstd_walk": 1, "torch.zstd_walk.native": 1, "torch.zstd_walk.literals": 1,
        "native under the walk": 1}


def _port(data: bytes, max_out=None):
    return extract.decompress_zstd_device(data, max_out, device="cpu")


def test_without_the_library_the_python_walk_matches_jax(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.zstd_walk_lib() is None
    blob, bad_inputs = _corrupted()
    frame = zstandard.ZstdCompressor(level=3).compress(blob)
    before = _walk_calls()
    for data in [frame] + bad_inputs[:16:4]:
        want = _outcome(jax_extract.decompress_zstd_device, data, len(blob))
        assert _outcome(_port, data, len(blob)) == want
    after = _walk_calls()
    assert after["torch.zstd_walk"] - before["torch.zstd_walk"] == 5
    assert after["torch.zstd_walk.native"] == before["torch.zstd_walk.native"]


def test_a_rejecting_native_walk_hands_over_to_the_python_walk(monkeypatch):
    """Where the native walk rejects an input the Python walk accepts, the
    Python walk's plan is used; where both reject, the Python walk's error
    is raised: the outcomes are those of the native walk."""
    blob, bad_inputs = _corrupted()
    inputs = [zstandard.ZstdCompressor(level=3).compress(blob), _rle_literals_frame()] \
        + bad_inputs[:16:2]
    want = [_outcome(_port, data) for data in inputs]
    monkeypatch.setattr(native.ZstdWalk, "sequences", lambda self: None)

    def python_literals():  # the Python walk's literal sections, opened under the walk
        return metrics.snapshot().get("torch.zstd_walk.literals", {}).get(
            "parents", {}).get("torch.zstd_walk", 0)

    before, lits = _walk_calls(), python_literals()
    assert [_outcome(_port, data) for data in inputs] == want
    after = _walk_calls()
    # the native walk ran and rejected every input, and the Python walk ran
    # after it: the two frames alone hold two compressed blocks
    assert after["torch.zstd_walk"] - before["torch.zstd_walk"] == len(inputs)
    assert after["torch.zstd_walk.native"] - before["torch.zstd_walk.native"] == len(inputs)
    assert python_literals() - lits >= 2
