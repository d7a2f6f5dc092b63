"""The port's zstd extract path on the CPU against the JAX package:
``decompress_zstd_device`` returns the same bytes as the JAX function of
the same name and raises ``DecompressError`` with the same message on the
same corrupted inputs; ``Reader.read_file`` of a zstd archive goes through
the port's codec, which steps down to the host decoders only on
``DecompressError``."""

import numpy as np
import pytest
import torch
import zstandard

from test_kernels import _seq_heavy_corpora
from zpack_tpu import native
from zpack_tpu.codecs.zstd import encode as zenc
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.parallel import extract as jax_extract
from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer, codecs, engine
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.codecs import zstd as port_zstd
from zpack_tpu_torch.parallel import extract

torch.set_num_threads(1)


def _corpora():
    rng = np.random.default_rng(3)
    return dict(_seq_heavy_corpora() + [
        ("rand", rng.integers(0, 256, 150000).astype(np.uint8).tobytes()),
        ("rle", b"\x42" * 200000)])


_COMPRESSORS = {
    "zstd3": lambda b: zstandard.ZstdCompressor(level=3).compress(b),
    "zstd19": lambda b: zstandard.ZstdCompressor(level=19).compress(b),
    "native3": lambda b: native.zstd_compress(b, 3),
}


def _outcome(fn, *args):
    """The bytes ``fn`` returns, or the message of the DecompressError it
    raises."""
    try:
        return fn(*args)
    except (DecompressError, JaxDecompressError) as e:
        return f"DecompressError: {e}"


def _port_device(data, max_out=None):
    return extract.decompress_zstd_device(data, max_out, device="cpu")


@pytest.mark.parametrize("comp", list(_COMPRESSORS))
@pytest.mark.parametrize("corpus", ["words", "strided", "rand", "rle"])
def test_device_route_matches_jax(corpus, comp):
    blob = _corpora()[corpus]
    frame = _COMPRESSORS[comp](blob)
    got = _port_device(frame, len(blob))
    assert got == blob
    assert got == jax_extract.decompress_zstd_device(frame, len(blob))


def test_concatenated_frames_raw_rle_and_skippable():
    """Frames of all four corpora back to back, the repo's own encoder's
    raw and RLE blocks, an empty frame and a skippable frame between."""
    blobs = list(_corpora().values())
    rng = np.random.default_rng(8)
    raw = bytes(rng.integers(0, 256, 30000).astype(np.uint8))
    parts = [zstandard.ZstdCompressor(level=3).compress(b) for b in blobs[1:]]
    parts += [zenc.compress(b"\x00" * 50000, 3), zenc.compress(raw, 3),
              zstandard.ZstdCompressor(level=3).compress(b""),
              b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"skip!"]
    multi = b"".join(parts)
    want = b"".join(blobs[1:]) + b"\x00" * 50000 + raw
    assert _port_device(multi) == want == jax_extract.decompress_zstd_device(multi)
    assert _port_device(b"") == b"" == jax_extract.decompress_zstd_device(b"")


def test_content_checksum_and_size_bound_as_jax():
    blob = _corpora()["strided"][:40000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(blob)
    assert _port_device(frame) == blob
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    jax_fn = jax_extract.decompress_zstd_device
    assert _outcome(_port_device, bad) == _outcome(jax_fn, bad) \
        == "DecompressError: content checksum mismatch"
    assert _outcome(_port_device, frame, len(blob) - 1) \
        == _outcome(jax_fn, frame, len(blob) - 1) \
        == "DecompressError: zstd output exceeds expected size"


def test_corruption_sweep_raises_where_jax_raises():
    """One byte flipped at 16 positions of a frame: the port raises the
    same DecompressError as the JAX path, or returns the same bytes."""
    blob = _corpora()["words"][:30000]
    frame = zstandard.ZstdCompressor(level=3).compress(blob)
    positions = np.linspace(4, len(frame) - 1, 16).astype(int).tolist()
    raised = 0
    for p in positions:
        bad = bytearray(frame)
        bad[p] ^= 0x5A
        bad = bytes(bad)
        want = _outcome(jax_extract.decompress_zstd_device, bad, len(blob))
        assert _outcome(_port_device, bad, len(blob)) == want, p
        raised += isinstance(want, str)
    assert raised >= 8


def test_reader_reads_zstd_entries_through_the_port():
    zstd = CompressOptions(CompressionMethod.ZSTD, 3)
    corpora = _corpora()
    entries = [("words.txt", corpora["words"][:150000], zstd),
               ("rand.bin", corpora["rand"], zstd),
               ("empty", b"", zstd)]
    before = codecs.device_setting()
    engine.install("cpu")
    try:
        w = Writer.to_heap()
        w.write_archive(entries)
        port_zstd.reset_fallbacks()
        r = Reader.from_memory(w.buffer, shared=True)
        for name, data, _ in entries:
            assert r.read_file(name) == data  # verifies the entry's XXH3
    finally:
        codecs.set_device(before)
    assert port_zstd.FALLBACKS == {"device_to_host": 0}


def test_codec_steps_down_only_on_decompress_error(monkeypatch):
    blob = _corpora()["strided"][:50000]
    frame = zstandard.ZstdCompressor(level=3).compress(blob)
    monkeypatch.setattr(codecs, "_DEVICE", torch.device("cpu"))
    codec = codecs.get_codec(int(CompressionMethod.ZSTD))
    assert isinstance(codec, port_zstd.ZstdCodec)

    def fail(exc):
        def f(*args, **kwargs):
            raise exc
        return f

    port_zstd.reset_fallbacks()
    monkeypatch.setattr(extract, "decompress_zstd_device", fail(RuntimeError("launch failed")))
    with pytest.raises(RuntimeError, match="launch failed"):
        codec.decompress(frame, len(blob))
    assert port_zstd.FALLBACKS == {"device_to_host": 0}
    monkeypatch.setattr(extract, "decompress_zstd_device", fail(DecompressError("x")))
    assert codec.decompress(frame, len(blob)) == blob  # the host decoder
    assert port_zstd.FALLBACKS == {"device_to_host": 1}
