"""zstd codec (method 1), host only.

The port has no zstd decode kernels yet.  ``ZstdCodec.decompress`` takes its JAX
device branch whenever ``ZPACK_TPU_ENGINE=tpu``, which the port's engine
sets for the LZ4 path, so the engine registers this subclass: the same
codec with that branch left out.
"""

from __future__ import annotations

from zpack_tpu import native
from zpack_tpu.codecs.zstd import ZstdCodec, frame
from zpack_tpu.utils.observe import metrics


class HostZstdCodec(ZstdCodec):
    """``ZstdCodec`` whose decompress never reaches the JAX device path."""

    def decompress(self, data: bytes, uncomp_size: int | None = None,
                   dictionary=None) -> bytes:
        with metrics.phase("zstd.decompress", uncomp_size or len(data)):
            if dictionary is not None:
                return frame.decompress(data, uncomp_size, dictionary=dictionary)
            if uncomp_size is not None:
                out = native.zstd_decompress(bytes(data), uncomp_size)
                if out is not None and len(out) == uncomp_size:
                    return out
            return frame.decompress(data, uncomp_size)
