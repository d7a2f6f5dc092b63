"""Compression pipeline on a device mesh: LZ4 frames and zstd frames.

Counterpart of ``zpack_tpu/parallel/pipeline.py`` (``make_mesh``,
``MeshCompressor``).  The input is padded into ``block_size`` blocks; a
step holds ``blocks_per_step`` blocks a mesh device, cut into contiguous
shards of blocks, one a device in the order of ``P("entry", "block")``
(the JAX ``shard_map`` step).  Each shard goes through the tokenizer kernel
on its device, and its wire format comes back to the host with the shard's
size estimate; the host sums the estimates (the JAX step's ``psum``).  No
padding row is launched: the last shard is shorter.  The wire format
mirrors ``_step_fn``: "u16" (one uint16 per byte) when the window, the
dictionary plus the block, is 8 KiB or less, else "pair".

* ``compress``: independent-block lz4f frames.  On a GPU each shard's
  blocks are serialized on its card beside the tables
  (``lz4_torch.serialize_sections``), and only the finished sections come
  back; the steps overlap: step s+1 is copied in, tokenized and serialized
  while the host appends step s (pinned buffers, one event a shard).  On
  the CPU the native serializer writes them from the wire format.  LZ4's
  fast levels (1 and 2) take the JAX engine's greedy parse at depth 2;
  its high-compression levels (:data:`HC_LEVEL` and up) an HC mode of the
  card's own: a deeper chain (``lz4_torch.hc_depth``), longer candidate
  comparisons (``lz4_torch.HC_CAPJ``) and the serializer's HC parse.
* ``compress_zstd``: one zstd block per device block; the host parses the
  match tables into sequences, the Huffman literal streams and the FSE
  sequence streams of all blocks are encoded in one launch a mesh device
  each (``kernels/huffman_torch.py``, ``kernels/fse_torch.py``), the host
  assembles the frame.  With a shared dictionary the dictionary is copied
  once to each distinct mesh device, rides the match window of every
  block, and each block becomes a frame of its own that references it,
  encoded on the host.

Both frames are byte-identical to the JAX engine's, whatever the step size
and the mesh, except LZ4 frames at HC levels, which the JAX engine writes
in its greedy parse at depth 8.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np
import torch

from .. import native
from ..codecs.lz4 import HC_LEVEL
from ..codecs.lz4 import frame as lz4frame
from ..codecs.zstd import encode as zenc
from ..codecs.zstd.dict import as_dictionary
from ..utils.observe import metrics

from ..kernels import fse_torch, huffman_torch, lz4_torch
from .mesh import DeviceMesh, as_mesh, make_mesh  # noqa: F401  (re-exported, as in the JAX module)

#: default block: 64 KiB, like the JAX engine and the native lz4f path
BLOCK = 64 << 10
#: the mode ``_steps_raw`` gives a shard whose blocks were serialized on its card
SECTIONS = "sections"


class DeviceCompressor:
    """Block-parallel LZ4 compressor on a torch device or a device mesh.

    ``compress(data)`` returns an lz4f frame of independent blocks, the same
    bytes whatever the mesh.  At levels 1 and 2 they are the bytes of
    ``MeshCompressor(...).compress(data)`` at the same block size: the
    greedy parse of the match finder's tables at depth 2.  At levels
    :data:`HC_LEVEL` and up (``parse`` "hc") the match finder walks
    ``lz4_torch.hc_depth`` candidates compared on up to
    ``lz4_torch.HC_CAPJ`` bytes, and the serializer takes the HC parse
    (``lz4_torch.serialize_plain``).
    ``tokenize`` and ``compress_zstd`` keep the JAX engine's depth, 2 at
    levels 1 and 2 and 8 above, at every level."""

    #: bytes tokenized a step on each mesh device: 256 blocks of 64 KiB,
    #: about two waves of one CTA per block on a 132-SM card
    BYTES_PER_STEP = 16 << 20

    def __init__(self, device, level: int = 1, block_size: int = BLOCK):
        """``device``: a torch device (a mesh of one) or a
        :class:`DeviceMesh`; results gather on its first device,
        ``self.device``."""
        if not 1 <= block_size <= 65536:
            raise ValueError(f"block size {block_size} outside 1..65536")
        self.mesh = as_mesh(device)
        self.device = self.mesh.devices[0]
        self.level = level
        self.block_size = block_size
        self.depth = 2 if level <= 2 else 8
        self.parse = "hc" if level >= HC_LEVEL else "greedy"
        self.blocks_per_step = max(1, self.BYTES_PER_STEP // block_size)

    def _mode(self, dict_pad: int = 0) -> str:
        """The step's wire format, the choice of ``_step_fn``: "u16" for a
        window of 8 KiB or less, else "pair"."""
        window = dict_pad + self.block_size
        if window <= 8192:
            return "u16"
        if window <= 65536:
            return "pair"
        raise ValueError(
            f"dict window {window} too large for the device tokenizer "
            f"(dict + block_size must be <= 65536)")

    def _lz4_match(self, mode: str) -> tuple[int, int]:
        """``(depth, capj)`` of the match finder for :meth:`compress`'s
        frames in wire format ``mode``."""
        if self.parse == "hc":
            return lz4_torch.hc_depth(self.level), lz4_torch.HC_CAPJ[mode]
        return self.depth, lz4_torch.CAPJ

    def _launch(self, chunk: np.ndarray, mode: str, device: torch.device,
                dict_dev: torch.Tensor | None, match: tuple[int, int],
                n_data: int | None = None):
        """Enqueue one shard on ``device``: copy in, build the windows (the
        dictionary first), tokenize, copy the wire format of the data
        positions and the shard's estimate out.  Returns the host tensors,
        the estimate last, and the event that marks them ready (None on the
        CPU, where the shard ran synchronously).  With ``n_data``, the
        shard's data bytes (a card only), the blocks are serialized there
        too, in :attr:`parse`, and the one host tensor is the sections'
        buffer (``lz4_torch.serialize_sections``) in place of the tables.
        ``match`` is the tokenizer's ``(depth, capj)``."""
        blocks = torch.from_numpy(chunk)
        cuda = device.type == "cuda"
        blocks = (blocks.pin_memory().to(device, non_blocking=True) if cuda
                  else blocks.to(device))
        dict_pad = 0
        if dict_dev is not None:
            dict_pad = dict_dev.numel()
            blocks = torch.cat([dict_dev.expand(len(blocks), dict_pad), blocks], dim=1)
        arrays, est = lz4_torch.tokenize_est(blocks, *match, mode, dict_pad)
        if not cuda:
            return (*arrays, est), None
        outs = (*arrays, est)
        if n_data is not None:
            outs = (lz4_torch.serialize_sections(blocks, arrays, mode, n_data, self.parse),)
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs)
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return host, done

    def _steps_raw(self, data: bytes, dictionary: bytes | None = None,
                   sections: bool = False, match: tuple[int, int] | None = None):
        """Yield (first_block, mode, wire arrays, est) a shard, in block
        order, with step s+1's shards enqueued before step s's are handed to
        the caller.  The wire arrays are ``(src u16, code u8)`` in "pair"
        mode and ``(tok u16,)`` in "u16" mode, each (blocks of the shard,
        B).  ``dictionary`` is copied once to each distinct mesh device.
        ``match`` is the tokenizer's ``(depth, capj)``, by default the JAX
        engine's.  With ``sections`` a shard on a card yields (first_block,
        :data:`SECTIONS`, (its sections' buffer,), None) instead."""
        B = self.block_size
        n = len(data)
        nb = max(1, math.ceil(n / B))
        flat = np.frombuffer(data, dtype=np.uint8)
        mode = self._mode(len(dictionary) if dictionary else 0)
        match = match or (self.depth, lz4_torch.CAPJ)
        dict_dev = dict.fromkeys(self.mesh.distinct())
        if dictionary:
            content = torch.frombuffer(bytearray(dictionary), dtype=torch.uint8)
            dict_dev = {d: content.to(d) for d in dict_dev}
        bps = self.blocks_per_step
        pending: list = []
        for step in range(0, nb, bps * self.mesh.size):
            launched = []
            for k, dev in enumerate(self.mesh.devices):
                lo = step + k * bps
                hi = min(nb, lo + bps)
                if lo >= hi:
                    break
                seg = flat[lo * B : min(n, hi * B)]
                with metrics.phase("torch.stage", len(seg)):
                    chunk = np.zeros((hi - lo, B), dtype=np.uint8)
                    chunk.reshape(-1)[: len(seg)] = seg
                on_card = sections and dev.type == "cuda"
                with metrics.phase("torch.dispatch", len(seg)):
                    launched.append((lo, SECTIONS if on_card else mode, self._launch(
                        chunk, mode, dev, dict_dev[dev], match, len(seg) if on_card else None)))
            for p in pending:
                yield self._wait(p)
            pending = launched
        for p in pending:
            yield self._wait(p)

    @staticmethod
    def _wait(pending):
        """Wait for a shard launched by :meth:`_launch`; its host arrays and
        its estimate."""
        lo, mode, (host, done) = pending
        with metrics.phase("torch.d2h", host[0].numel()):
            with metrics.phase("torch.d2h.wait", sum(t.nbytes for t in host)):
                if done is not None:
                    done.synchronize()
                host = tuple(t.cpu().numpy() for t in host)
            if mode == SECTIONS:
                return lo, mode, host, None
            *arrays, est = host
            return lo, mode, tuple(arrays), int(est[0])

    def compress(self, data: bytes) -> bytes:
        """One lz4f frame of independent blocks: device tokenization, then
        each shard's sections serialized on its card and appended as they
        come back; on the CPU, host serialization by
        ``native.lz4_serialize_blocks_packed`` (the greedy parse) or
        ``native.lz4_serialize_blocks_hc`` (the HC parse), which take the
        "pair" and the "u16" wire format as they come.  Both routes write
        the same bytes."""
        data = bytes(data)
        B = self.block_size
        n = len(data)
        # B <= 64 KiB, so the declared frame block size is the smallest, 64 KiB
        out = bytearray(lz4frame._header(64 << 10, True, False, None))
        hc = self.parse == "hc"
        match = self._lz4_match(self._mode())
        for lo, mode, host, _est in self._steps_raw(data, sections=True, match=match):
            end = min(n, (lo + self.blocks_per_step) * B)
            if mode == SECTIONS:
                with metrics.phase("torch.serialize", end - lo * B):
                    metrics.count("lz4.serialize.device", nbytes=end - lo * B)
                    if hc:
                        metrics.count("lz4.compress.hc", nbytes=end - lo * B)
                    out += lz4_torch.sections(host[0])
                continue
            with metrics.phase("torch.frame", end - lo * B):
                seg = data[lo * B : end]
            with metrics.phase("torch.serialize", len(seg)):
                metrics.count("lz4.serialize.host", nbytes=len(seg))
                if hc:
                    metrics.count("lz4.compress.hc", nbytes=len(seg))
                    body = native.lz4_serialize_blocks_hc(seg, mode, host, B)
                else:
                    body = native.lz4_serialize_blocks_packed(seg, mode, host, B)
            if body is None:
                raise RuntimeError(
                    "the native LZ4 serializer is unavailable (native.py "
                    "could not build or load its library)")
            with metrics.phase("torch.frame", len(body)):
                out += body
        with metrics.phase("torch.frame", len(out) + 4):
            out += struct.pack("<I", 0)
            return bytes(out)

    def tokenize(self, data: bytes, dictionary: bytes | None = None):
        """``(src, mlen, nb, est_total)``: the position-ordered int32 match
        tables of the ``nb`` blocks, ``(nb, B)`` each (``src`` -1 where there
        is no match; with ``dictionary``, relative to the start of the
        window, the dictionary's first byte), and the host sum of the
        shards' size estimates.  The tables of ``MeshCompressor.tokenize`` without its
        mesh padding rows, which its ``est_total`` counts and this one does
        not (``lz4_torch.est_plain``)."""
        data = bytes(data)
        B = self.block_size
        nb = max(1, math.ceil(len(data) / B))
        src = np.empty((nb, B), dtype=np.int32)
        mlen = np.empty((nb, B), dtype=np.int32)
        est_total = 0
        for lo, mode, host, est in self._steps_raw(data, dictionary):
            with metrics.phase("torch.host_unpack", host[0].size):
                src_s, mlen_s = lz4_torch.from_jax_wire(mode, host)
            src[lo:lo + len(src_s)] = src_s
            mlen[lo:lo + len(mlen_s)] = mlen_s
            est_total += est
        return src, mlen, nb, est_total

    def compress_zstd(self, data: bytes, level: int = 3, dictionary=None,
                      device_entropy: bool | None = None) -> bytes:
        """One zstd frame, one block per device-tokenized block: the port of
        ``MeshCompressor.compress_zstd``, with the same bytes.  Offsets stay
        within a block (window = block size).

        The tokenizer's depth comes from the constructor's ``level``;
        ``level`` here reaches only the empty input's frame.  With
        ``device_entropy`` (default: on unless ``ZPACK_TPU_NO_DEVICE_ENTROPY``
        is set) the literal Huffman streams and the FSE sequence streams of
        all blocks are encoded on the mesh, their rows sharded over its
        devices; without it, by the host
        encoders of ``codecs.zstd``.

        With ``dictionary`` (a ``ZstdDictionary``, a dictionary blob or raw
        content) the dictionary rides every block's match window on the
        device and each block becomes an independent frame that references
        it, so offsets stay local to the window."""
        if dictionary is not None:
            return self._compress_zstd_dict(data, level, dictionary)
        if device_entropy is None:
            device_entropy = not os.environ.get("ZPACK_TPU_NO_DEVICE_ENTROPY")
        data = bytes(data)
        B = self.block_size
        n = len(data)
        if n == 0:
            return zenc.compress(b"", level)
        src, mlen, nb, _est = self.tokenize(data)
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

    def _compress_zstd_dict(self, data: bytes, level: int, dictionary) -> bytes:
        """Shared-dictionary path, the port of
        ``MeshCompressor._compress_zstd_dict``: the dictionary on the device,
        one dictionary-referencing frame per block (concatenated frames are
        valid zstd; each decodes against the same dictionary).  The entropy
        stage runs on the host, as in the JAX package."""
        zd = as_dictionary(dictionary)
        d = len(zd.content)
        B = self.block_size
        data = bytes(data)
        n = len(data)
        if n == 0:
            return zenc.compress(b"", level, dictionary=zd)
        src, mlen, nb, _est = self.tokenize(data, zd.content)  # raises if d + B > 65536
        wl = max(17, (d + B).bit_length())
        out = bytearray()
        posa = np.arange(B)
        zeros_d = np.zeros(d, dtype=np.int64)
        with metrics.phase("torch.zstd_dict_encode", n):
            for i in range(nb):
                chunk = data[i * B:(i + 1) * B]
                cl = len(chunk)
                arr = np.frombuffer(zd.content + chunk, dtype=np.uint8)
                # clamp device results (computed over the zero-padded tail
                # block) to the real chunk length; zstd lets matches run to
                # the block end, so the only rule is staying inside [0, cl)
                ml = np.minimum(mlen[i], np.maximum(cl - posa, 0))
                ml = np.where(ml < 4, 0, ml)
                src_full = np.concatenate([zeros_d, src[i].astype(np.int64)])
                ml_full = np.concatenate([zeros_d, ml.astype(np.int64)])
                mps, mss, mls = lz4_torch.resolve_matches_host(
                    arr, src_full, ml_full, d + cl, d + cl, lz4_torch.CAPJ)
                lit_starts = np.concatenate([[d], mps + mls])
                seqs = [(int(ls), int(p - ls), int(p), int(j), int(l))
                        for ls, p, j, l in zip(lit_starts[:-1], mps, mss, mls)]
                seqs.append((int(lit_starts[-1]), d + cl - int(lit_starts[-1]),
                             None, None, None))
                rep = list(zd.rep)
                # fresh per block: each block is its own frame
                enc_tabs = zd.encode_tables()
                ent = zenc.EntropyState(*enc_tabs) if enc_tabs is not None else None
                body = zenc._encode_block_body(arr, d, d + cl, seqs, rep, ent=ent)
                out += zenc._frame_header(cl, wl, dict_id=zd.dict_id, min_window=d + cl)
                if body is not None and len(body) < cl:
                    out += struct.pack("<I", 1 | (2 << 1) | (len(body) << 3))[:3]
                    out += body
                else:
                    out += struct.pack("<I", 1 | (0 << 1) | (cl << 3))[:3]
                    out += chunk
        return bytes(out)

    def _device_huffman(self) -> huffman_torch.TorchHuffmanEncoder:
        """Cached Huffman literal-stream encoder on the mesh."""
        enc = getattr(self, "_huff_enc", None)
        if enc is None:
            enc = self._huff_enc = huffman_torch.TorchHuffmanEncoder(self.mesh)
        return enc

    def _device_fse(self) -> fse_torch.TorchSequenceEncoder:
        """Cached FSE sequence-stream encoder on the mesh."""
        enc = getattr(self, "_fse_enc", None)
        if enc is None:
            enc = self._fse_enc = fse_torch.TorchSequenceEncoder(self.mesh)
        return enc
