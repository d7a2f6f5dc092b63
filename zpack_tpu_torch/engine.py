"""Put the port's device engine into the ``zpack_tpu`` codec registry.

Counterpart of the JAX package's engine switch (``ZPACK_TPU_ENGINE=tpu``,
``codecs/__init__.py``).  :func:`install` makes the ``Writer``, ``Reader``
and CLI of ``zpack_tpu`` run LZ4 and zstd extract on ``device``:

* method 2 becomes :class:`TorchLZ4Codec` on ``device``;
* method 1 becomes :class:`TorchZstdCodec` on ``device``: its decompress
  (what ``Reader.read_file`` calls) decodes on the device, so zstd never
  takes the JAX device branch; it compresses with the native host encoder;
* ``ZPACK_TPU_ENGINE=tpu`` makes the writer and the CLI hand whole entries
  to the codec instead of their native shortcuts.

:func:`uninstall` restores all three.
"""

from __future__ import annotations

import functools
import os

import torch

from zpack_tpu import codecs
from zpack_tpu.constants import CompressionMethod

from .codecs.lz4 import TorchLZ4Codec
from .codecs.zstd import TorchZstdCodec

_METHODS = (int(CompressionMethod.ZSTD), int(CompressionMethod.LZ4))
_saved: tuple[dict, str | None] | None = None


def install(device="cuda") -> None:
    """Route the archive codecs through the port on ``device`` ("cuda",
    "cuda:N" or "cpu").  Raises RuntimeError for a CUDA device when no GPU
    is visible."""
    global _saved
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if _saved is None:
        _saved = ({m: codecs._REGISTRY.get(m) for m in _METHODS},
                  os.environ.get("ZPACK_TPU_ENGINE"))
    codecs.register(CompressionMethod.LZ4)(functools.partial(TorchLZ4Codec, dev))
    codecs.register(CompressionMethod.ZSTD)(functools.partial(TorchZstdCodec, dev))
    for m in _METHODS:
        codecs._INSTANCES.pop(m, None)
    os.environ["ZPACK_TPU_ENGINE"] = "tpu"


def uninstall() -> None:
    """Restore the registry and ``ZPACK_TPU_ENGINE`` as :func:`install`
    found them."""
    global _saved
    if _saved is None:
        return
    factories, env = _saved
    for m, factory in factories.items():
        if factory is None:
            codecs._REGISTRY.pop(m, None)
        else:
            codecs._REGISTRY[m] = factory
        codecs._INSTANCES.pop(m, None)
    if env is None:
        os.environ.pop("ZPACK_TPU_ENGINE", None)
    else:
        os.environ["ZPACK_TPU_ENGINE"] = env
    _saved = None
