"""zstd codec (method 1): self-contained frame/FSE/Huffman implementation.

With a device set in the registry (``codecs.set_device``, through
``engine.install``) ``decompress`` tries the fully device-resident decode
(``decompress_zstd_device``) and takes one step down, to the host decoders,
on a ``DecompressError`` only: a build, launch or CUDA error propagates.
The step is counted in :data:`FALLBACKS` as ``device_to_host``.  The JAX
codec has a middle step (Huffman on the device, sequences on the host); the
port has none, and the host decoders answer what would reach it.  Frames
with a dictionary go to the host decoder, and ``compress`` and the
streaming decoder (what the CLI's ``x`` and ``t`` use) stay the native host
codecs, as in the JAX package.
"""

from __future__ import annotations

from ... import native
from ...constants import CompressionMethod
from ...errors import DecompressError
from .. import Codec, device, register
from . import frame

#: steps down from the device decode, counted by ``ZstdCodec.decompress``
FALLBACKS = {"device_to_host": 0}


def reset_fallbacks() -> None:
    for k in FALLBACKS:
        FALLBACKS[k] = 0


@register(CompressionMethod.ZSTD)
class ZstdCodec(Codec):
    """ZPack method 1 — zstd frames (parity: ZSTD_compressCCtx /
    ZSTD_decompressDCtx dispatch at lib/zpack_write.c:179 and
    lib/zpack_read.c:380)."""

    method = CompressionMethod.ZSTD

    def compress(self, data: bytes, level: int = 3, dictionary=None) -> bytes:
        from ...utils.observe import metrics

        with metrics.phase("zstd.compress", len(data)):
            if dictionary is not None:
                from . import encode

                return encode.compress(data, level, dictionary=dictionary)
            if len(data) > (16 << 20):
                from ...parallel import host

                comp = host.zstd_compress_parallel(bytes(data), level)
                if comp is not None:
                    return comp
            comp = native.zstd_compress(bytes(data), level)
            if comp is not None:
                return comp
            from . import encode

            return encode.compress(data, level)

    def decompress(self, data: bytes, uncomp_size: int | None = None,
                   dictionary=None) -> bytes:
        from ...utils.observe import metrics

        with metrics.phase("zstd.decompress", uncomp_size or len(data)):
            if dictionary is not None:
                return frame.decompress(data, uncomp_size, dictionary=dictionary)
            dev = device()
            if dev is not None:
                # device engine: fully device-resident entropy decode
                # (huffman + FSE + rep resolution + sequence execution);
                # steps down to the host decoders
                from ...parallel.extract import decompress_zstd_device

                try:
                    return decompress_zstd_device(bytes(data), uncomp_size, device=dev)
                except DecompressError:
                    FALLBACKS["device_to_host"] += 1
            if uncomp_size is not None:
                # native zn_zstd_decompress is internally frame-parallel;
                # the old >16 MiB host.zstd_decompress_parallel detour
                # (python slicing + join + nested pools) measured 0.6x it
                out = native.zstd_decompress(bytes(data), uncomp_size)
                if out is not None and len(out) == uncomp_size:
                    return out
            return frame.decompress(data, uncomp_size)

    def compress_bound(self, size: int) -> int:
        # ZSTD_compressBound shape: size + size/256 + fixed block overhead
        return size + (size >> 8) + (((128 << 10) - size) >> 11 if size < (128 << 10) else 0) + 64

    def compressor(self, level: int = 3, dictionary=None):
        from . import encode

        return encode.StreamCompressor(level, dictionary=dictionary)

    def decompressor(self, dictionary=None):
        return _ZstdStreamDecompressor(dictionary=dictionary)


class _ZstdStreamDecompressor:
    """Block-incremental streaming decoder (parity: ZSTD_decompressStream
    at lib/zpack_read.c:572): consumes arbitrary chunks, emits output as
    each block completes; retained state = entropy tables + history window,
    so memory stays bounded for arbitrarily long frames.

    Fast path: when a whole frame with a declared content size fits in the
    buffer, it is scanned (block headers only) and decoded in one native
    call; the python per-block path handles everything else."""

    def __init__(self, dictionary=None):
        import struct as _struct

        self._struct = _struct
        self._buf = bytearray()
        self._state = "magic"
        self._dec: frame.FrameDecoder | None = None
        self._skip_left = 0
        self.finished = False
        self._dict = None
        if dictionary is not None:
            from .dict import as_dictionary

            self._dict = as_dictionary(dictionary)
        # preferred engine: the native incremental dstream decodes each
        # block the moment it completes (bounded memory, native speed, and
        # honest read_back timing for the caller-buffer streaming mode);
        # the python state machine below is the fallback/oracle.  The
        # native dstream has no dictionary state, so dict mode stays on
        # the python path.
        from ... import native

        self._native = None if self._dict is not None else native.zstd_dstream()

    def _decompress_native(self, chunk: bytes, is_final: bool) -> tuple[bytes, int]:
        out = self._native.feed(chunk, is_final)
        if is_final:
            self.finished = True
        return out, len(chunk)

    def _try_native_frame(self, out: bytearray) -> bool:
        """At a frame magic: scan block headers; if the complete frame is
        buffered and declares its content size, decode it natively."""
        from ... import native

        buf = self._buf
        try:
            hdr = frame.parse_frame_header(bytes(buf[4:22]), 0)
        except Exception:
            return False
        if hdr.content_size is None:
            return False
        p = 4 + hdr.header_size
        while True:
            if len(buf) < p + 3:
                return False  # frame not fully buffered yet
            bh = buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16)
            p += 3 + (1 if ((bh >> 1) & 3) == frame.BLOCK_RLE else (bh >> 3))
            if bh & 1:
                break
        if hdr.has_checksum:
            p += 4
        if len(buf) < p:
            return False
        decoded = native.zstd_decompress(bytes(buf[:p]), hdr.content_size)
        if decoded is None or len(decoded) != hdr.content_size:
            return False
        out += decoded
        del buf[:p]
        return True

    def decompress(self, chunk: bytes, is_final: bool = False) -> tuple[bytes, int]:
        from ...errors import DecompressError

        if self._native is not None:
            return self._decompress_native(chunk, is_final)
        struct = self._struct
        self._buf += chunk
        out = bytearray()
        buf = self._buf
        while True:
            if self._state == "magic":
                if len(buf) < 4:
                    break
                (magic,) = struct.unpack_from("<I", buf, 0)
                if frame.MAGIC_SKIPPABLE_MIN <= magic <= frame.MAGIC_SKIPPABLE_MAX:
                    if len(buf) < 8:
                        break
                    (size,) = struct.unpack_from("<I", buf, 4)
                    del buf[:8]
                    self._skip_left = size
                    self._state = "skippable"
                    continue
                if magic != frame.MAGIC:
                    raise DecompressError(f"bad zstd magic {magic:#x}")
                if self._dict is None and self._try_native_frame(out):
                    continue  # whole frame decoded natively
                if not is_final and len(buf) < (12 << 20):
                    break  # wait for more of the frame before falling back
                del buf[:4]
                self._state = "header"
                continue
            if self._state == "skippable":
                take = min(self._skip_left, len(buf))
                del buf[:take]
                self._skip_left -= take
                if self._skip_left == 0:
                    self._state = "magic"
                    continue
                break
            if self._state == "header":
                # frame headers are <= 14 bytes; parse when enough arrived
                try:
                    hdr = frame.parse_frame_header(bytes(buf[:18]), 0)
                except DecompressError:
                    if not is_final and len(buf) < 18:
                        break  # likely truncated: wait for more
                    raise
                if hdr.dict_id and self._dict is None:
                    raise DecompressError(
                        f"frame requires dictionary {hdr.dict_id} (none attached)")
                del buf[: hdr.header_size]
                if self._dict is not None:
                    self._dec = frame._dict_decoder(hdr, self._dict)
                else:
                    self._dec = frame.FrameDecoder(hdr)
                self._state = "block"
                continue
            if self._state == "block":
                if len(buf) < 3:
                    break
                bh = buf[0] | (buf[1] << 8) | (buf[2] << 16)
                last = bh & 1
                btype = (bh >> 1) & 3
                bsize = bh >> 3
                need = 3 + (1 if btype == frame.BLOCK_RLE else bsize)
                if len(buf) < need:
                    break
                payload = bytes(buf[3:need])
                del buf[:need]
                if btype == frame.BLOCK_RLE:
                    out += self._dec.decode_block(btype, payload, bsize)
                else:
                    out += self._dec.decode_block(btype, payload)
                if last:
                    self._state = "checksum" if self._dec.header.has_checksum else "magic"
                continue
            if self._state == "checksum":
                if len(buf) < 4:
                    break
                (chk,) = struct.unpack_from("<I", buf, 0)
                del buf[:4]
                if (self._dec.hasher.digest() & 0xFFFFFFFF) != chk:
                    raise DecompressError("content checksum mismatch")
                self._state = "magic"
                continue
            break
        if is_final:
            if self._state != "magic" or self._buf:
                raise DecompressError("truncated zstd stream")
            self.finished = True
        return bytes(out), len(chunk)
