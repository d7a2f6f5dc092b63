"""The port's device mesh against the JAX package's, on the CPU.

``make_mesh`` shapes; ``DeviceCompressor`` over meshes of 1, 2, 3 and 8 CPU
"devices" (3 divides no step) against ``MeshCompressor`` on the JAX
8-device CPU mesh: LZ4 frames, zstd frames with device entropy on and off,
the 8 KiB dictionary frames, the match tables and the size estimate; the
four row-sharded entropy wrappers on 3 shards against one device on every
batch of the case modules, errors included; and ``decompress_zstd_device``
with ``mesh=`` against the JAX function with ``mesh=make_mesh()``.  All
outputs are bytes or integers: exact."""

import functools

import jax
import numpy as np
import pytest
import torch
import zstandard

from test_kernels import _mix
from zpack_tpu.codecs.zstd.dict import train_dictionary as jax_train_dictionary
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.parallel import extract as jax_extract
from zpack_tpu.parallel import pipeline as jax_pipeline
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import (fse_cases, fse_encode_cases, fse_torch, huffman_cases,
                                     huffman_encode_cases, huffman_torch, lz4_torch)
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.parallel.mesh import DeviceMesh, row_ranges
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor, make_mesh

torch.set_num_threads(1)

SHARDS = [1, 2, 3, 8]
#: blocks of the test input: a ragged tail, no multiple of any mesh here
N_BLOCKS = 10


def _input(B: int) -> bytes:
    return _mix((N_BLOCKS - 1) * B + 1234, seed=B)


@pytest.fixture
def small_steps(monkeypatch):
    """Steps of two blocks a device, so that an input spans several steps
    and the last one leaves shards short or empty."""
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 2 * 4096)


@functools.lru_cache(maxsize=None)
def _jax_compressor(B: int) -> jax_pipeline.MeshCompressor:
    """``MeshCompressor(make_mesh())`` on the 8-device CPU mesh, built with
    steps of two blocks a device (its frames do not depend on the step;
    the default pads every call to 8 MiB of blocks)."""
    assert len(jax.devices()) == 8
    cls = jax_pipeline.MeshCompressor
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "BYTES_PER_DEVICE_STEP", 2 * B)
        return cls(jax_pipeline.make_mesh(), block_size=B)


@functools.lru_cache(maxsize=None)
def _jax_frames(B: int) -> dict:
    data = _input(B)
    mc = _jax_compressor(B)
    return {"lz4": mc.compress(data), "zstd": mc.compress_zstd(data, 3, device_entropy=True),
            "zstd_host": mc.compress_zstd(data, 3, device_entropy=False)}


@functools.lru_cache(maxsize=None)
def _blob() -> bytes:
    data = _input(8192)
    return jax_train_dictionary([data[i:i + 512] for i in range(0, 8192, 512)], 2048)


@functools.lru_cache(maxsize=None)
def _jax_dict_frames() -> bytes:
    return _jax_compressor(8192).compress_zstd(_input(8192), 3, dictionary=_blob())


def _mesh(k: int) -> DeviceMesh:
    return make_mesh(["cpu"] * k)


@pytest.mark.parametrize("n,entry_axis", [(n, e) for n in range(1, 9) for e in (None, 1, 2, 4)
                                            if e is None or e <= n])
def test_make_mesh_shapes_match_jax(n, entry_axis):
    want = jax_pipeline.make_mesh(jax.devices()[:n], entry_axis)
    got = make_mesh(["cpu"] * n, entry_axis)
    assert got.shape == dict(want.shape)
    assert got.size == want.devices.size
    assert [len(row) for row in got.grid] == [want.devices.shape[1]] * want.devices.shape[0]


def test_make_mesh_needs_a_gpu_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh(["cuda:0", "cuda:0"])


def test_a_device_is_a_mesh_of_one_and_rows_split_contiguously():
    dc = DeviceCompressor("cpu")
    assert dc.mesh.shape == {"entry": 1, "block": 1} and dc.device == torch.device("cpu")
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape == {"entry": 4, "block": 2} and mesh.distinct() == [torch.device("cpu")]
    assert row_ranges(10, 3) == [(0, 4), (4, 8), (8, 10)]
    assert row_ranges(4, 3) == [(0, 2), (2, 4), (4, 4)]
    assert row_ranges(2, 8)[2:] == [(2, 2)] * 6


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_lz4_and_zstd_frames_match_jax_mesh(k, small_steps):
    data, want = _input(4096), _jax_frames(4096)
    dc = DeviceCompressor(_mesh(k), block_size=4096)
    assert dc.compress(data) == want["lz4"]
    assert dc.compress_zstd(data, 3, device_entropy=True) == want["zstd"]
    assert dc.compress_zstd(data, 3, device_entropy=False) == want["zstd_host"]
    assert zstandard.ZstdDecompressor().decompress(want["zstd"], max_output_size=len(data)) == data


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_dictionary_frames_match_jax_mesh(k, small_steps):
    data = _input(8192)
    got = DeviceCompressor(_mesh(k), block_size=8192).compress_zstd(data, 3, dictionary=_blob())
    assert got == _jax_dict_frames()


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_launches_once_per_shard_per_step(k, small_steps):
    calls = []
    real = lz4_torch.tokenize_plain

    def spy(blocks, *a, **kw):
        calls.append(len(blocks))
        return real(blocks, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lz4_torch, "tokenize_plain", spy)
        DeviceCompressor(_mesh(k), block_size=4096).compress(_input(4096))
    # two blocks a shard; the last shard of the ten blocks may be short
    assert calls == [2] * 5


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_tokenize_matches_jax_and_est_on_full_steps(k, small_steps):
    """The tables equal JAX's first ``nb`` rows; on an input that fills the
    JAX mesh's steps (no padding row) the estimates agree too."""
    B = 4096
    data = _input(B)
    src, mlen, nb, _ = DeviceCompressor(_mesh(k), block_size=B).tokenize(data)
    want_src, want_mlen, want_nb, _ = _jax_compressor(B).tokenize(data)
    assert nb == want_nb == N_BLOCKS
    assert np.array_equal(src, want_src[:nb]) and np.array_equal(mlen, want_mlen[:nb])
    mc = _jax_compressor(B)
    full = _mix(8 * mc.blocks_per_device_step * B, seed=5)  # one whole JAX step
    est = DeviceCompressor(_mesh(k), block_size=B).tokenize(full)[3]
    assert est == mc.tokenize(full)[3]


# ---------------------------------------------------------------------------
# The four sharded entropy wrappers: 3 shards against one device
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return fn()
    except (DecompressError, JaxDecompressError) as e:
        return f"DecompressError: {e}"


@pytest.mark.parametrize("name", list(huffman_encode_cases.cases()))
def test_sharded_huffman_encode_equals_one_device(name):
    case = huffman_encode_cases.cases()[name]

    def run(dev):
        return getattr(huffman_torch.TorchHuffmanEncoder(dev), case.method)(case.items, case.tables)

    one = run("cpu")
    assert run(_mesh(3)) == one == huffman_encode_cases.host_payloads(case)


@pytest.mark.parametrize("name", list(fse_encode_cases.cases()))
def test_sharded_fse_encode_equals_one_device(name):
    case = fse_encode_cases.cases()[name]
    one = fse_torch.TorchSequenceEncoder("cpu").encode_batch(case.blocks, case.tables)
    assert fse_torch.TorchSequenceEncoder(_mesh(3)).encode_batch(case.blocks, case.tables) == one


@pytest.mark.parametrize("name", list(huffman_cases.cases()))
def test_sharded_huffman_decode_equals_one_device(name):
    """On the built batch (the malformed rows as the case edits them) and
    through the wrapper's streams; a shard writes only its own streams'
    destinations, out-of-order and out-of-range ones included."""
    case = huffman_cases.cases()[name]
    n_out = case.batch["n_out"]
    syms1, final1 = huffman_torch.TorchHuffmanDecoder("cpu").decode_built(case.batch, n_out)
    syms3, final3 = huffman_torch.TorchHuffmanDecoder(_mesh(3)).decode_built(case.batch, n_out)
    assert np.array_equal(final3, final1)
    assert torch.equal(syms3, syms1)
    if name != "malformed":
        payloads, tables, n = zip(*case.streams)
        got = huffman_torch.TorchHuffmanDecoder(_mesh(3)).decode_batch_device(
            list(payloads), list(tables), list(n), case.batch["rows"][:, 4].tolist(), n_out)
        assert torch.equal(got[0], syms1) and np.array_equal(got[1], final1)


@pytest.mark.parametrize("name", list(fse_cases.cases()))
def test_sharded_fse_decode_equals_one_device(name):
    """Values equal, and a corrupt item raises the same message for the
    same first bad item on 1 and 3 shards."""
    items = fse_cases.cases()[name].items

    def run(dev):
        def go():
            (lls, mls, ovs), seq_off = fse_torch.TorchSequenceDecoder(dev).decode_batch_device(items)
            return [t.numpy().tolist() for t in (lls, mls, ovs)], seq_off.tolist()
        return _outcome(go)

    assert run(_mesh(3)) == run("cpu")


def test_sharded_fse_decode_reports_the_first_bad_item_in_order():
    """A stream not consumed in shard 0 and one over-read in shard 2: the
    message is the first item's, as on one device."""
    case = fse_cases.cases()
    good = [it for c in case.values() for it, e in zip(c.items, c.expect) if e == "ok"][:6]
    bad = fse_cases._corrupt(good[0])
    items = good[:1] + [bad["unconsumed"]] + good[1:4] + [bad["over-read"]]
    msgs = {k: _outcome(lambda k=k: fse_torch.TorchSequenceDecoder(
        "cpu" if k == 1 else _mesh(k)).decode_batch_device(items)) for k in (1, 2, 3)}
    assert msgs[1] == msgs[2] == msgs[3] == "DecompressError: sequence bitstream not fully consumed"


# ---------------------------------------------------------------------------
# Mesh extract
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zstd_entry() -> tuple:
    data = _input(65536)[:150000]
    return data, zstandard.ZstdCompressor(level=3).compress(data)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_mesh_extract_matches_jax_mesh(k):
    data, comp = _zstd_entry()
    got = extract.decompress_zstd_device(comp, len(data), device="cpu", mesh=_mesh(k))
    assert got == data == jax_extract.decompress_zstd_device(comp, len(data),
                                                             mesh=jax_pipeline.make_mesh())


def test_mesh_extract_raises_as_jax_mesh_on_a_corrupted_frame():
    data, comp = _zstd_entry()
    raised = 0
    for p in np.linspace(8, len(comp) - 1, 6).astype(int).tolist():
        bad = bytearray(comp)
        bad[p] ^= 0x5A
        bad = bytes(bad)
        want = _outcome(lambda: jax_extract.decompress_zstd_device(
            bad, len(data), mesh=jax_pipeline.make_mesh()))
        assert _outcome(lambda: extract.decompress_zstd_device(
            bad, len(data), device="cpu", mesh=_mesh(3))) == want, p
        raised += isinstance(want, str)
    assert raised >= 3
