"""The port's zstd compress path (``DeviceCompressor.tokenize`` and
``compress_zstd``) against the JAX package's mesh pipeline on one device:
match tables equal, frames byte-identical, frames decode with ``zstandard``
and the python oracle.  On the CPU the entropy kernels run their plain
versions."""

import jax
import numpy as np
import pytest
import torch
import zstandard

from test_torch_pipeline import KINDS, _data
from zpack_tpu.codecs.zstd import frame as ZF
from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

torch.set_num_threads(1)

_MESH = {}


def _mesh(B: int) -> MeshCompressor:
    if B not in _MESH:
        _MESH[B] = MeshCompressor(make_mesh(jax.devices()[:1]), block_size=B)
    return _MESH[B]


@pytest.mark.parametrize("B", [4096, 65536])
def test_tokenize_matches_mesh(B):
    """At 4 KiB the JAX engine tokenizes in "u16" mode and the port in
    "pair": the tables must still be equal.  The JAX tables are padded to
    whole mesh steps; the port's are not."""
    data = _data("mix", B)
    src, mlen, nb = DeviceCompressor("cpu", block_size=B).tokenize(data)
    want_src, want_mlen, want_nb, _est = _mesh(B).tokenize(data)
    assert nb == want_nb == -(-len(data) // B)
    assert src.shape == mlen.shape == (nb, B)
    assert np.array_equal(src, want_src[:nb])
    assert np.array_equal(mlen, want_mlen[:nb])
    assert (mlen > 0).sum() > 100


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("device_entropy", [True, False])
@pytest.mark.parametrize("B", [4096, 65536])
def test_compress_zstd_matches_mesh(B, device_entropy, kind):
    data = _data(kind, B)
    got = DeviceCompressor("cpu", block_size=B).compress_zstd(data, 3, device_entropy=device_entropy)
    assert got == _mesh(B).compress_zstd(data, 3, device_entropy=device_entropy)
    assert ZF.decompress(got) == data
    assert zstandard.ZstdDecompressor().decompress(got, max_output_size=max(len(data), 1)) == data


def test_device_entropy_follows_env(monkeypatch):
    """Default entropy mode: device unless ZPACK_TPU_NO_DEVICE_ENTROPY; the
    frame is the same bytes either way."""
    from zpack_tpu_torch.kernels import fse_torch, huffman_torch

    data = _data("mix", 4096)
    dc = DeviceCompressor("cpu", block_size=4096)
    calls = []
    for mod, name in ((huffman_torch, "encode_streams_plain"), (fse_torch, "encode_seq_streams_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    dev = dc.compress_zstd(data)
    assert sorted(set(calls)) == ["encode_seq_streams_plain", "encode_streams_plain"]
    calls.clear()
    monkeypatch.setenv("ZPACK_TPU_NO_DEVICE_ENTROPY", "1")
    assert dc.compress_zstd(data) == dev
    assert calls == []


def test_level_sets_tokenizer_depth_only():
    """The constructor's level picks the tokenizer depth (2 at levels 1-2,
    8 above); compress_zstd's level reaches only the empty frame."""
    data = _data("mix", 4096)
    for level in (1, 5):
        mc = MeshCompressor(make_mesh(jax.devices()[:1]), level=level, block_size=4096)
        dc = DeviceCompressor("cpu", level=level, block_size=4096)
        want = mc.compress_zstd(data, 3)
        assert dc.compress_zstd(data, 3) == want == mc.compress_zstd(data, 19)
        assert dc.compress_zstd(data, 19) == want
    assert DeviceCompressor("cpu").compress_zstd(b"", 7) == _mesh(65536).compress_zstd(b"", 7)


def test_dictionary_not_ported():
    with pytest.raises(NotImplementedError, match="item 8"):
        DeviceCompressor("cpu").compress_zstd(b"abc" * 100, 3, dictionary=b"abc" * 50)
