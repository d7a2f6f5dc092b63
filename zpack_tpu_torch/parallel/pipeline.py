"""Single-device compression pipeline: LZ4 frames and zstd frames.

Counterpart of ``zpack_tpu/parallel/pipeline.py`` (``MeshCompressor``) on
one device with no mesh: the input is padded into ``block_size`` blocks,
each step of blocks goes through the tokenizer kernel, and the pair wire
format comes back to the host.

* ``compress``: the native serializer writes independent-block lz4f frames
  from it.  On a GPU the steps overlap: step s+1 is copied in and tokenized
  while the host serializes step s (pinned buffers, one event per step).
* ``compress_zstd``: one zstd block per device block; the host parses the
  match tables into sequences, the Huffman literal streams and the FSE
  sequence streams of all blocks are encoded in one launch each
  (``kernels/huffman_torch.py``, ``kernels/fse_torch.py``), the host
  assembles the frame.

Both frames are byte-identical to the JAX engine's, whatever the step size.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np
import torch

from zpack_tpu import native
from zpack_tpu.codecs.lz4 import frame as lz4frame
from zpack_tpu.codecs.zstd import encode as zenc
from zpack_tpu.utils.observe import metrics

from ..kernels import fse_torch, huffman_torch, lz4_torch

#: default block: 64 KiB, like the JAX engine and the native lz4f path
BLOCK = 64 << 10


class DeviceCompressor:
    """Block-parallel LZ4 compressor on one torch device.

    ``compress(data)`` returns an lz4f frame of independent blocks, the same
    bytes as ``MeshCompressor(...).compress(data)`` at the same level and
    block size."""

    #: bytes tokenized per step: 256 blocks of 64 KiB, about two waves of
    #: one CTA per block on a 132-SM card
    BYTES_PER_STEP = 16 << 20

    def __init__(self, device, level: int = 1, block_size: int = BLOCK):
        if not 1 <= block_size <= 65536:
            raise ValueError(f"block size {block_size} outside 1..65536")
        self.device = torch.device(device)
        self.level = level
        self.block_size = block_size
        self.depth = 2 if level <= 2 else 8
        self.blocks_per_step = max(1, self.BYTES_PER_STEP // block_size)

    def _launch(self, chunk: np.ndarray):
        """Enqueue one step: copy in, tokenize, copy the pair wire format
        out.  Returns the host tensors and the event that marks them ready
        (None on the CPU, where the step ran synchronously)."""
        blocks = torch.from_numpy(chunk)
        if self.device.type != "cuda":
            return lz4_torch.tokenize(blocks.to(self.device), self.depth), None
        blocks = blocks.pin_memory().to(self.device, non_blocking=True)
        src, code = lz4_torch.tokenize(blocks, self.depth)
        host = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                torch.empty(code.shape, dtype=code.dtype, pin_memory=True))
        host[0].copy_(src, non_blocking=True)
        host[1].copy_(code, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _steps_raw(self, data: bytes):
        """Yield (first_block, (src u16, code u8)) per step, in order, with
        step s+1 enqueued before step s is handed to the caller."""
        B = self.block_size
        n = len(data)
        nb = max(1, math.ceil(n / B))
        flat = np.frombuffer(data, dtype=np.uint8)
        pending = None
        for lo in range(0, nb, self.blocks_per_step):
            hi = min(nb, lo + self.blocks_per_step)
            chunk = np.zeros((hi - lo, B), dtype=np.uint8)
            seg = flat[lo * B : min(n, hi * B)]
            chunk.reshape(-1)[: len(seg)] = seg
            with metrics.phase("torch.dispatch", len(seg)):
                launched = (lo, self._launch(chunk))
            if pending is not None:
                yield self._wait(pending)
            pending = launched
        yield self._wait(pending)

    @staticmethod
    def _wait(pending):
        """Wait for a step launched by :meth:`_launch`; its host arrays."""
        lo, (host, done) = pending
        with metrics.phase("torch.d2h", host[0].numel()):
            if done is not None:
                done.synchronize()
            return lo, tuple(t.cpu().numpy() for t in host)

    def compress(self, data: bytes) -> bytes:
        """One lz4f frame of independent blocks: device tokenization, host
        serialization by ``native.lz4_serialize_blocks_packed``."""
        data = bytes(data)
        B = self.block_size
        n = len(data)
        # B <= 64 KiB, so the declared frame block size is the smallest, 64 KiB
        out = bytearray(lz4frame._header(64 << 10, True, False, None))
        for lo, host in self._steps_raw(data):
            seg = data[lo * B : min(n, (lo + len(host[0])) * B)]
            with metrics.phase("torch.serialize", len(seg)):
                body = native.lz4_serialize_blocks_packed(seg, "pair", host, B)
            if body is None:
                raise RuntimeError(
                    "the native LZ4 serializer is unavailable (zpack_tpu.native "
                    "could not build or load its library)")
            out += body
        out += struct.pack("<I", 0)
        return bytes(out)

    def tokenize(self, data: bytes):
        """``(src, mlen, nb)``: the position-ordered int32 match tables of the
        ``nb`` blocks, ``(nb, B)`` each (``src`` -1 where there is no match).
        The tables of ``MeshCompressor.tokenize`` without its mesh padding
        rows and its size estimate."""
        data = bytes(data)
        B = self.block_size
        nb = max(1, math.ceil(len(data) / B))
        src = np.empty((nb, B), dtype=np.int32)
        mlen = np.empty((nb, B), dtype=np.int32)
        for lo, host in self._steps_raw(data):
            with metrics.phase("torch.host_unpack", host[0].size):
                src_s, mlen_s = lz4_torch.unpack_resort_host(*host)
            src[lo:lo + len(src_s)] = src_s
            mlen[lo:lo + len(mlen_s)] = mlen_s
        return src, mlen, nb

    def compress_zstd(self, data: bytes, level: int = 3, dictionary=None,
                      device_entropy: bool | None = None) -> bytes:
        """One zstd frame, one block per device-tokenized block: the port of
        ``MeshCompressor.compress_zstd``, with the same bytes.  Offsets stay
        within a block (window = block size).

        The tokenizer's depth comes from the constructor's ``level``;
        ``level`` here reaches only the empty input's frame.  With
        ``device_entropy`` (default: on unless ``ZPACK_TPU_NO_DEVICE_ENTROPY``
        is set) the literal Huffman streams and the FSE sequence streams of
        all blocks are encoded on ``self.device``; without it, by the host
        encoders of ``codecs.zstd``."""
        if dictionary is not None:
            raise NotImplementedError(
                "compress_zstd with a dictionary is not ported yet "
                "(ROADMAP Queue 1 item 8, the shared-dictionary path)")
        if device_entropy is None:
            device_entropy = not os.environ.get("ZPACK_TPU_NO_DEVICE_ENTROPY")
        data = bytes(data)
        B = self.block_size
        n = len(data)
        if n == 0:
            return zenc.compress(b"", level)
        src, mlen, nb = self.tokenize(data)
        # pass 1: device match tables -> sequence tuples + literal runs
        all_seqs: list[list] = []
        all_lits: list[bytes] = []
        posa = np.arange(B)
        with metrics.phase("torch.zstd_parse", n):
            for i in range(nb):
                chunk = data[i * B:(i + 1) * B]
                cl = len(chunk)
                arr = np.frombuffer(chunk, dtype=np.uint8)
                ml = mlen[i]
                if cl != B:
                    ml = np.minimum(ml, np.maximum(cl - 5 - posa, 0))
                    ml = np.where(posa >= max(cl - 12, 0), 0, ml)
                    ml = np.where(ml < 4, 0, ml)
                # zstd has no end-of-block literal rule, so limit = cl
                mps, mss, mls = lz4_torch.resolve_matches_host(
                    arr, src[i], ml, cl, cl, lz4_torch.CAPJ)
                lit_starts = np.concatenate([[0], mps + mls])
                seqs = [(int(ls), int(p - ls), int(p), int(j), int(l))
                        for ls, p, j, l in zip(lit_starts[:-1], mps, mss, mls)]
                seqs.append((int(lit_starts[-1]), cl - int(lit_starts[-1]), None, None, None))
                all_seqs.append(seqs)
                all_lits.append(zenc._block_literals(arr, seqs))
        # entropy stage: one launch for every block's Huffman literal streams
        enc = self._device_huffman() if device_entropy else None
        with metrics.phase("torch.entropy_encode", sum(len(l) for l in all_lits)):
            lit_sections = zenc.encode_literal_sections(all_lits, enc)
        # pass 2a: sequence fields + table choice, host-sequential (the
        # repcode state threads block to block); the compressed-vs-raw
        # decision uses sequence_section_header's bitstream upper bound, so
        # the repcode rollback for raw blocks happens before the launch
        plans: list[tuple] = []  # ("dev", header, fields, tables) | ("host", body | None)
        rep = [1, 4, 8]
        with metrics.phase("torch.zstd_plan", n):
            for i in range(nb):
                chunk = data[i * B:(i + 1) * B]
                cl = len(chunk)
                arr = np.frombuffer(chunk, dtype=np.uint8)
                rep_backup = list(rep)
                lls, mls, ovs, _n_lits = zenc.sequence_fields(arr, all_seqs[i], rep)
                if lls and lit_sections[i] is not None:
                    header, tables, ub_bits = zenc.sequence_section_header(lls, mls, ovs)
                    size_ub = len(lit_sections[i]) + len(header) + (ub_bits + 7) // 8
                    if device_entropy and size_ub < cl:
                        plans.append(("dev", header, (lls, mls, ovs), tables))
                        continue
                # no sequences, marginal, or host entropy: the exact host
                # encode decides
                rep[:] = rep_backup
                body = zenc._encode_block_body(arr, 0, cl, all_seqs[i], rep,
                                               lit_section=lit_sections[i])
                if not (body and len(body) < cl):
                    body = None
                    rep[:] = rep_backup
                plans.append(("host", body))
        # pass 2b: one launch packs every planned block's FSE sequence stream
        dev_idx = [i for i, p in enumerate(plans) if p[0] == "dev"]
        streams: list[bytes] = []
        if dev_idx:
            with metrics.phase("torch.fse_encode", sum(len(plans[i][2][0]) for i in dev_idx)):
                streams = self._device_fse().encode_batch(
                    [plans[i][2] for i in dev_idx], [plans[i][3] for i in dev_idx])
        stream_of = dict(zip(dev_idx, streams))
        # pass 2c: frame assembly
        with metrics.phase("torch.zstd_frame", n):
            out = bytearray(zenc._frame_header(n, max(17, B.bit_length())))
            for i in range(nb):
                chunk = data[i * B:(i + 1) * B]
                cl = len(chunk)
                last = 1 if i == nb - 1 else 0
                plan = plans[i]
                if plan[0] == "dev":
                    body = lit_sections[i] + plan[1] + stream_of[i]
                    if len(body) >= cl:
                        raise AssertionError("sequence upper bound violated")
                else:
                    body = plan[1]
                if body is not None:
                    out += struct.pack("<I", last | (2 << 1) | (len(body) << 3))[:3]
                    out += body
                else:
                    out += struct.pack("<I", last | (0 << 1) | (cl << 3))[:3]
                    out += chunk
        return bytes(out)

    def _device_huffman(self) -> huffman_torch.TorchHuffmanEncoder:
        """Cached Huffman literal-stream encoder on ``self.device``."""
        enc = getattr(self, "_huff_enc", None)
        if enc is None:
            enc = self._huff_enc = huffman_torch.TorchHuffmanEncoder(self.device)
        return enc

    def _device_fse(self) -> fse_torch.TorchSequenceEncoder:
        """Cached FSE sequence-stream encoder on ``self.device``."""
        enc = getattr(self, "_fse_enc", None)
        if enc is None:
            enc = self._fse_enc = fse_torch.TorchSequenceEncoder(self.device)
        return enc
