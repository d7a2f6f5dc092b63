"""The port's zstd compress path (``DeviceCompressor.tokenize`` and
``compress_zstd``) against the JAX package's mesh pipeline on one device:
match tables equal, frames byte-identical (plain and with a shared
dictionary), frames decode with ``zstandard`` and the python oracle.  On the
CPU the kernels run their plain versions."""

import io

import jax
import numpy as np
import pytest
import torch
import zstandard

from test_torch_pipeline import KINDS, _data
from zpack_tpu.codecs.zstd import frame as jax_ZF
from zpack_tpu.codecs.zstd.dict import parse_dictionary as jax_parse_dictionary
from zpack_tpu.codecs.zstd.dict import train_dictionary as jax_train_dictionary
from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh
from zpack_tpu_torch.codecs.zstd import frame as ZF
from zpack_tpu_torch.codecs.zstd.dict import parse_dictionary, train_dictionary
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

torch.set_num_threads(1)

_MESH = {}


def _mesh(B: int) -> MeshCompressor:
    if B not in _MESH:
        _MESH[B] = MeshCompressor(make_mesh(jax.devices()[:1]), block_size=B)
    return _MESH[B]


@pytest.mark.parametrize("B", [4096, 65536])
def test_tokenize_matches_mesh(B):
    """At 4 KiB both engines tokenize in "u16" mode, at 64 KiB in "pair".
    The JAX tables are padded to whole mesh steps; the port's are not."""
    data = _data("mix", B)
    src, mlen, nb, _est = DeviceCompressor("cpu", block_size=B).tokenize(data)
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
    assert jax_ZF.decompress(got) == data
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


def _dict_data(kind: str, B: int) -> bytes:
    base = _data("mix", 8192)
    return {"ragged": base[: 5 * B + 4321], "whole": base[: 3 * B], "short": base[:1000],
            "noise": _data("noise", B), "zeros": bytes(2 * B + 77), "empty": b""}[kind]


def _blob() -> bytes:
    """A 2 KiB trained dictionary, the recipe of ``dryrun_multichip``."""
    base = _data("mix", 8192)
    return train_dictionary([base[i:i + 512] for i in range(0, 8192, 512)], 2048)


def test_train_dictionary_copy_gives_the_same_blob():
    base = _data("mix", 8192)
    assert _blob() == jax_train_dictionary([base[i:i + 512] for i in range(0, 8192, 512)], 2048)


@pytest.mark.parametrize("kind", ["ragged", "whole", "short", "noise", "zeros", "empty"])
@pytest.mark.parametrize("B", [4096, 8192])
def test_compress_zstd_with_dictionary_matches_mesh(B, kind):
    """One dictionary-referencing frame per block, byte-identical to the JAX
    engine's: "u16" mode at 4 KiB blocks (window 6,144), "pair" at 8 KiB
    (window 10,240)."""
    data, blob = _dict_data(kind, B), _blob()
    dc = DeviceCompressor("cpu", block_size=B)
    assert dc._mode(2048) == ("u16" if B == 4096 else "pair")
    got = dc.compress_zstd(data, 3, dictionary=blob)
    assert got == _mesh(B).compress_zstd(data, 3, dictionary=blob)
    assert ZF.decompress(got, dictionary=blob) == data
    assert jax_ZF.decompress(got, dictionary=blob) == data
    dctx = zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(blob))
    assert dctx.stream_reader(io.BytesIO(got), read_across_frames=True).read() == data


def test_compress_zstd_takes_a_parsed_and_a_raw_dictionary():
    data, blob = _dict_data("ragged", 4096), _blob()
    dc = DeviceCompressor("cpu", block_size=4096)
    assert dc.compress_zstd(data, 3, dictionary=parse_dictionary(blob)) == \
        dc.compress_zstd(data, 3, dictionary=blob)
    raw = _data("mix", 8192)[:1500]  # no magic: raw content, dict_id 0
    got = dc.compress_zstd(data, 3, dictionary=raw)
    assert got == _mesh(4096).compress_zstd(data, 3, dictionary=raw)
    assert ZF.decompress(got, dictionary=raw) == data


def test_dictionary_pays_for_itself_and_frames_do_not_depend_on_step_size():
    data, blob = _dict_data("ragged", 4096), _blob()
    dc = DeviceCompressor("cpu", block_size=4096)
    with_dict = dc.compress_zstd(data, 3, dictionary=blob)
    assert len(with_dict) < len(dc.compress_zstd(data, 3))
    one = DeviceCompressor("cpu", block_size=4096)
    one.blocks_per_step = 1
    assert one.compress_zstd(data, 3, dictionary=blob) == with_dict


def test_dictionary_window_over_64k_raises_like_mesh():
    blob = _blob()
    d = len(jax_parse_dictionary(blob).content)
    B = 65536 - d + 1
    with pytest.raises(ValueError) as want:
        MeshCompressor(make_mesh(jax.devices()[:1]), block_size=B).compress_zstd(
            b"x" * 1000, 3, dictionary=blob)
    with pytest.raises(ValueError) as got:
        DeviceCompressor("cpu", block_size=B).compress_zstd(b"x" * 1000, 3, dictionary=blob)
    assert str(got.value) == str(want.value)
    assert "must be <= 65536" in str(got.value)
