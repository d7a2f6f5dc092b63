"""zstd codec (method 1) on a torch device.

Counterpart of the device branch of ``zpack_tpu/codecs/zstd/__init__.py``
(``ZPACK_TPU_ENGINE=tpu``): ``decompress`` tries the fully device-resident
decode (:func:`decompress_zstd_device`), then the Huffman-only hybrid
(:func:`decompress_zstd_batched`), then the host decoders, as the JAX codec
does, with one difference: only ``DecompressError`` takes a step down, so a
build, launch or CUDA error propagates.  Each step down is counted in
:data:`FALLBACKS`.  Frames with a dictionary go to the host decoder, and
``compress`` and the streaming decoder (what the CLI's ``x`` and ``t``
use) stay the native host codecs, as in the JAX package.
"""

from __future__ import annotations

import torch

from zpack_tpu import native
from zpack_tpu.codecs.zstd import ZstdCodec, frame
from zpack_tpu.errors import DecompressError
from zpack_tpu.utils.observe import metrics

from ..parallel.extract import decompress_zstd_batched, decompress_zstd_device

#: steps down from the device decode, counted by ``TorchZstdCodec.decompress``
FALLBACKS = {"device_to_batched": 0, "batched_to_host": 0}


def reset_fallbacks() -> None:
    for k in FALLBACKS:
        FALLBACKS[k] = 0


class TorchZstdCodec(ZstdCodec):
    """ZPack method 1 with the port's device decode on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def decompress(self, data: bytes, uncomp_size: int | None = None,
                   dictionary=None) -> bytes:
        with metrics.phase("zstd.decompress", uncomp_size or len(data)):
            if dictionary is not None:
                return frame.decompress(data, uncomp_size, dictionary=dictionary)
            try:
                return decompress_zstd_device(bytes(data), uncomp_size, device=self.device)
            except DecompressError:
                FALLBACKS["device_to_batched"] += 1
            try:
                return decompress_zstd_batched(bytes(data), uncomp_size, device=self.device)
            except DecompressError:
                FALLBACKS["batched_to_host"] += 1
            if uncomp_size is not None:
                out = native.zstd_decompress(bytes(data), uncomp_size)
                if out is not None and len(out) == uncomp_size:
                    return out
            return frame.decompress(data, uncomp_size)
