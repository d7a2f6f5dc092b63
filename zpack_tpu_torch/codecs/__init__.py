"""Codec registry.

The reference dispatches on ``comp_method`` at every (de)compress site
(e.g. lib/zpack_read.c:352-443, lib/zpack_write.c:161-239).  Here each method
is a :class:`Codec` with one-shot and streaming entry points; the device
routes (the CUDA kernels behind ``parallel/``) and the host paths share this
interface.

The registry also holds the device the codecs' device routes run on
(:func:`set_device`, :func:`device`).  The state at import is
:data:`DEFAULT_DEVICE` ("cuda"), resolved at the first :func:`device` call,
which raises when no GPU is visible; ``engine.install`` names another device
and ``engine.uninstall`` sets ``None``, which keeps every codec on its host
engines.  The JAX package's counterpart of this setting is its
``ZPACK_TPU_ENGINE`` switch, which this package never reads.
"""

from __future__ import annotations

from typing import Callable

from ..constants import CompressionMethod
from ..errors import CompMethodError


class Codec:
    """Interface for one compression method."""

    method: CompressionMethod

    def compress(self, data: bytes, level: int = 0) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        raise NotImplementedError

    def compress_bound(self, size: int) -> int:
        """Worst-case compressed size for ``size`` input bytes
        (parity: zpack_get_compress_bound, lib/zpack_write.c:125-141)."""
        raise NotImplementedError

    # Streaming: return objects with .update(chunk)->bytes and .finish()->bytes /
    # .decompress(chunk)->(out, consumed) — wired up by ``stream``.
    def compressor(self, level: int = 0):
        raise NotImplementedError

    def decompressor(self):
        raise NotImplementedError


_REGISTRY: dict[int, Callable[[], Codec]] = {}
_INSTANCES: dict[int, Codec] = {}
#: the device of the device routes until ``engine.install`` or
#: ``engine.uninstall`` says otherwise
DEFAULT_DEVICE = "cuda"
_DEVICE = DEFAULT_DEVICE  # a name until :func:`device` resolves it


def resolve_device(device):
    """``device`` ("cuda", "cuda:N", "cpu" or a ``torch.device``) as a
    ``torch.device``.  Raises RuntimeError for a CUDA device when no GPU is
    visible, ValueError for any other kind of device."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is available "
            "(engine.install('cpu') runs the device routes on the CPU, "
            "engine.uninstall() keeps the host engines)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def set_device(device) -> None:
    """Set the device of the codecs' device routes: a ``torch.device``, a
    name that :func:`device` resolves at its next call, or ``None``, which
    turns the routes off (host engines only)."""
    global _DEVICE
    _DEVICE = device


def device_setting():
    """The setting as it stands, unresolved: what :func:`set_device` takes
    to put it back."""
    return _DEVICE


def device():
    """The ``torch.device`` of the device routes, or ``None`` when they are
    off.  Raises RuntimeError when the setting names a GPU and none is
    visible."""
    global _DEVICE
    if isinstance(_DEVICE, str):
        _DEVICE = resolve_device(_DEVICE)
    return _DEVICE


def register(method: CompressionMethod):
    def deco(factory: Callable[[], Codec]):
        _REGISTRY[int(method)] = factory
        return factory

    return deco


def _disabled(method: int) -> bool:
    """Runtime analog of the reference's build-time codec gates
    (ZPACK_DISABLE_{ZSTD,LZ4}, reference: CMakeLists.txt:10-21 →
    ZPACK_ERROR_NOT_AVAILABLE paths e.g. lib/zpack_read.c:371,397).
    Checked per call so tests/users can toggle at runtime; the dict lookup
    is the only overhead on the hot path."""
    import os

    name = _GATE_NAMES.get(int(method))
    return name is not None and name in os.environ


_GATE_NAMES = {1: "ZPACK_TPU_DISABLE_ZSTD", 2: "ZPACK_TPU_DISABLE_LZ4"}


def get_codec(method: int) -> Codec:
    if _disabled(method):
        from ..errors import Result, ZPackError

        raise ZPackError(Result.ERROR_NOT_AVAILABLE, f"method {method} disabled in this build")
    try:
        inst = _INSTANCES.get(int(method))
        if inst is None:
            inst = _REGISTRY[int(method)]()
            _INSTANCES[int(method)] = inst
        return inst
    except KeyError:
        raise CompMethodError(method) from None


class StoreCodec(Codec):
    """Method 0 ("none"): raw bytes (parity: the memcpy branches at
    lib/zpack_read.c:352-366 and lib/zpack_write.c:168-175)."""

    method = CompressionMethod.NONE

    def compress(self, data: bytes, level: int = 0) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes, uncomp_size: int | None = None) -> bytes:
        return bytes(data)

    def compress_bound(self, size: int) -> int:
        return size

    def compressor(self, level: int = 0):
        return _StoreStream()

    def decompressor(self):
        return _StoreStream()


class _StoreStream:
    def update(self, chunk: bytes) -> bytes:
        return bytes(chunk)

    def finish(self) -> bytes:
        return b""

    def decompress(self, chunk: bytes, is_final: bool = False) -> tuple[bytes, int]:
        return bytes(chunk), len(chunk)


register(CompressionMethod.NONE)(StoreCodec)


def _register_builtin():
    # Imported lazily to keep the base format layer importable while codec
    # modules are under construction.
    from . import lz4 as _lz4  # noqa: F401
    from . import zstd as _zstd  # noqa: F401


try:
    _register_builtin()
except ImportError:
    pass
