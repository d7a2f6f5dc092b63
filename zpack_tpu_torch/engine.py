"""Set the device of the package's codec registry.

Counterpart of the JAX package's engine switch (``ZPACK_TPU_ENGINE=tpu``,
read by its codecs, writer and CLI).  Here the device is explicit.  The
``Writer``, ``Reader`` and CLI of this package run LZ4 compress and extract
and zstd extract on the GPU unless the caller says otherwise, and raise when
none is visible; :func:`install` names another device:

* method 2 (``codecs.lz4.LZ4Codec``) compresses entries of 64 KiB or more
  with :class:`DeviceCompressor` and replays frames on the device;
* method 1 (``codecs.zstd.ZstdCodec``) decodes on the device (what
  ``Reader.read_file`` calls); it compresses with the native host encoder;
* the writer and the CLI hand whole entries to the codec instead of their
  native shortcuts.

:func:`uninstall` turns the device routes off (host engines only).  Nothing
outside this package is touched: no environment variable is set and no other
registry is written.
"""

from __future__ import annotations

from . import codecs
from .utils.observe import metrics


def install(device="cuda") -> None:
    """Route the archive codecs through ``device`` ("cuda", "cuda:N" or
    "cpu").  Raises RuntimeError for a CUDA device when no GPU is visible."""
    with metrics.phase("engine.install"):
        codecs.set_device(codecs.resolve_device(device))


def uninstall() -> None:
    """Turn the device routes off: every codec back on its host engines."""
    codecs.set_device(None)
