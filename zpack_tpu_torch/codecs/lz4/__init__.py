"""LZ4 codec (method 2): frame format on disk, block codec underneath.

With a device set in the registry (``codecs.set_device``, through
``engine.install``) entries of 64 KiB or more compress through
:class:`DeviceCompressor` and frames of independent blocks decode through
the batched device replay, the counterparts of the JAX package's
``ZPACK_TPU_ENGINE=tpu`` branches; smaller entries take the host frame
encoder exactly as the JAX engine splits them, so archives are
byte-identical.  Frames whose header says the blocks are linked go to the
host decoder.  Streaming (``decompressor()``, what the CLI's ``x`` and ``t``
use) stays on the host ``FrameDecompressor``.  The device routes swallow no
error: a CUDA or build error propagates.

Each entry counts its route in the registry, under its codec phase: one
``lz4.compress.device`` or ``lz4.compress.host``, one
``lz4.decompress.device`` or ``lz4.decompress.host`` (the Reader's in-place
decode of a many-frame entry counts the last), with the entry's bytes.
``lz4.compress.hc`` counts the bytes LZ4's high-compression mode took
(levels :data:`HC_LEVEL` and up): on the device route each shard that the
HC parse serialized (``parallel/pipeline.py``), on the host route each
entry that the host encoder's hash-chain search wrote.
"""

from __future__ import annotations

import struct

from ...constants import CompressionMethod
from .. import Codec, device, register
from . import block, frame

#: entries at least this large go to the device, as in the JAX engine
DEVICE_MIN = 64 << 10
#: the first level of LZ4's high-compression mode (LZ4HC_CLEVEL_MIN)
HC_LEVEL = 3


def _linked_frame(data: bytes) -> bool:
    """True when ``data`` starts with an lz4f frame of linked blocks."""
    return (len(data) >= 5 and struct.unpack_from("<I", data)[0] == frame.MAGIC
            and not data[4] & 0x20)


@register(CompressionMethod.LZ4)
class LZ4Codec(Codec):
    """ZPack method 2 — LZ4 frame format (docs/specs.md:101).

    compress_bound parity: zpack_get_compress_bound's LZ4F branch
    (lib/zpack_write.c:125-141) — frame header + per-block overhead.
    """

    method = CompressionMethod.LZ4

    def compress(self, data: bytes, level: int = 1) -> bytes:
        from ...utils.observe import metrics

        with metrics.phase("lz4.compress", len(data)):
            dev = device()
            if dev is not None and len(data) >= DEVICE_MIN:
                # device engine: block-parallel tokenization on the device
                from ...parallel.pipeline import DeviceCompressor

                metrics.count("lz4.compress.device", nbytes=len(data))
                return DeviceCompressor(dev, level).compress(bytes(data))
            metrics.count("lz4.compress.host", nbytes=len(data))
            if level >= HC_LEVEL:
                # the host encoder walks a hash chain as deep as the level asks
                metrics.count("lz4.compress.hc", nbytes=len(data))
            if len(data) > (2 << 20):
                # one linked frame per 2 MiB chunk: encode chunks AND
                # decode frames in parallel; the only ratio cost is one
                # 64 KiB window restart per chunk (~0.1% on mixed data)
                from ...parallel import host

                comp = host.lz4f_compress_parallel(bytes(data), level,
                                                   chunk=2 << 20)
                if comp is not None:
                    return comp
            return frame.compress_frame(data, level)

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        from ...utils.observe import metrics

        nbytes = uncomp_size or len(data)
        with metrics.phase("lz4.decompress", nbytes):
            dev = device()
            if dev is not None and not _linked_frame(data):
                # device engine: batched device sequence replay
                from ...parallel.extract import decompress_lz4f_batched

                metrics.count("lz4.decompress.device", nbytes=nbytes)
                return decompress_lz4f_batched(bytes(data), uncomp_size, device=dev)
            metrics.count("lz4.decompress.host", nbytes=nbytes)
            if len(data) > (1 << 20):
                # concatenated frames (the chunked encoder's output) decode
                # frame-parallel; returns None for single/foreign frames
                from ...parallel import host

                out = host.lz4f_decompress_parallel(bytes(data), uncomp_size)
                if out is not None:
                    return out
            return frame.decompress_frame(data, uncomp_size)

    def compress_bound(self, size: int) -> int:
        nblocks = max(1, -(-size // frame.DEFAULT_BLOCK_SIZE))
        return 19 + size + 8 * nblocks + 16

    def compressor(self, level: int = 1):
        return frame.FrameCompressor(level)

    def decompressor(self):
        return _LZ4StreamDecompressor()


class _LZ4StreamDecompressor:
    def __init__(self):
        self._d = frame.FrameDecompressor()

    def decompress(self, chunk: bytes, is_final: bool = False) -> tuple[bytes, int]:
        out = self._d.update(chunk)
        return out, len(chunk)

    @property
    def finished(self) -> bool:
        return self._d.finished
