"""Batched lz4f and zstd extraction on a torch device.

Counterpart of ``zpack_tpu/parallel/extract.py``.

* :func:`decompress_lz4f_batched`: the frame structure is walked on the
  host (magic, descriptor, header checksum, block checksums, content
  checksum), and every compressed block of every frame is parsed and
  replayed in one batch by the port's replayer (on a GPU, both on the
  card).  Frames with linked blocks raise, because their history makes
  decoding sequential; the codec sends those to the host decoder before
  calling here.
* :func:`decompress_zstd_device`: the host walks frame and block headers
  and builds the decode tables (the native walk, ``native/zstd_walk.cpp``,
  in two calls an entry; :func:`walk_zstd` where the library lacks it or
  rejects the input), then the device decodes every Huffman literal
  stream, every FSE sequence section and every repeat offset, the assembly
  lays the sequences out per frame with torch ops, and each frame replays
  as one row of the LZ4 replayer.
* :func:`decompress_zstd_batched`, its fallback: Huffman literals on the
  device, sequences on the host.
"""

from __future__ import annotations

import struct
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import native
from ..codecs.lz4 import frame as lz4f
from ..codecs.xxh3 import XXH32State, XXH64State, xxh32
from ..codecs.zstd import frame as zframe, seq as zseq
from ..errors import DecompressError
from ..utils.observe import metrics

from ..kernels import fse_torch, huffman_torch, lz4_torch
from ..kernels.huffman_torch import TorchHuffmanDecoder
from ..kernels.lz4_torch import DeviceLZ4Replayer


def walk_lz4f(data: bytes):
    """Walk concatenated lz4f frames without decoding a block.

    Returns ``(pieces, comp_blocks, comp_bounds, hash_spans)``: pieces are
    ``("raw", bytes)`` or ``("dev", index into comp_blocks)``; comp_bounds
    are the blocks' declared maximum sizes; hash_spans are
    ``(first_piece, n_pieces, expected_xxh32)`` per content-checksummed
    frame."""
    pos = 0
    n = len(data)
    pieces: list[tuple] = []
    comp_blocks: list[bytes] = []
    comp_bounds: list[int] = []
    hash_spans: list[tuple] = []
    while pos < n:
        if n - pos < 4:
            raise DecompressError("truncated lz4 frame magic")
        (magic,) = struct.unpack_from("<I", data, pos)
        if lz4f.MAGIC_SKIPPABLE_MIN <= magic <= lz4f.MAGIC_SKIPPABLE_MAX:
            if n - pos < 8:
                raise DecompressError("truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != lz4f.MAGIC:
            raise DecompressError(f"bad lz4 frame magic {magic:#x}")
        pos += 4
        if n - pos < 3:
            raise DecompressError("truncated lz4 frame descriptor")
        flg, bd = data[pos], data[pos + 1]
        if (flg >> 6) != 1:
            raise DecompressError("unsupported lz4 frame version")
        if not (flg & 0x20):
            raise DecompressError("linked blocks: host path required")
        desc_len = 2 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0)
        if n - pos < desc_len + 1:
            raise DecompressError("truncated lz4 frame descriptor")
        bsid = (bd >> 4) & 0x7
        if bsid not in lz4f._BLOCK_SIZES:
            raise DecompressError(f"bad lz4 block size id {bsid}")
        block_max = lz4f._BLOCK_SIZES[bsid]
        hc = data[pos + desc_len]
        if hc != ((xxh32(bytes(data[pos : pos + desc_len]), 0) >> 8) & 0xFF):
            raise DecompressError("lz4 frame header checksum mismatch")
        block_checksum = bool(flg & 0x10)
        content_checksum = bool(flg & 0x04)
        pos += desc_len + 1
        frame_piece0 = len(pieces)
        while True:
            if n - pos < 4:
                raise DecompressError("truncated lz4 block header")
            (bsize,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if bsize == 0:
                break
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            if bsize > block_max:
                raise DecompressError("lz4 block larger than declared maximum")
            payload = bytes(data[pos : pos + bsize])
            if len(payload) < bsize:
                raise DecompressError("truncated lz4 block")
            pos += bsize
            if block_checksum:
                if n - pos < 4:
                    raise DecompressError("truncated lz4 block checksum")
                (bchk,) = struct.unpack_from("<I", data, pos)
                pos += 4
                if xxh32(payload, 0) != bchk:
                    raise DecompressError("lz4 block checksum mismatch")
            if uncompressed:
                pieces.append(("raw", payload))
            else:
                pieces.append(("dev", len(comp_blocks)))
                comp_blocks.append(payload)
                comp_bounds.append(block_max)
        if content_checksum:
            if n - pos < 4:
                raise DecompressError("truncated lz4 content checksum")
            (chk,) = struct.unpack_from("<I", data, pos)
            pos += 4
            hash_spans.append((frame_piece0, len(pieces) - frame_piece0, chk))
    return pieces, comp_blocks, comp_bounds, hash_spans


def decompress_lz4f_batched(data: bytes, max_out: int | None = None, *,
                            device) -> bytes:
    """Batched lz4f frame decode: frames walked on the host, every
    compressed independent block parsed and replayed in one batch on
    ``device``."""
    with metrics.phase("torch.lz4f_walk", len(data)):
        pieces, comp_blocks, comp_bounds, hash_spans = walk_lz4f(data)
    decoded = DeviceLZ4Replayer(device).decompress_blocks(comp_blocks, comp_bounds)
    with metrics.phase("torch.lz4f_join", len(pieces)):
        parts = [p[1] if p[0] == "raw" else decoded[p[1]] for p in pieces]
        for p0, cnt, chk in hash_spans:
            with metrics.phase("torch.lz4f_checksum", sum(map(len, parts[p0:p0 + cnt]))):
                h = XXH32State(0)
                for part in parts[p0 : p0 + cnt]:
                    h.update(part)
            if h.digest() != chk:
                raise DecompressError("lz4 content checksum mismatch")
        out = b"".join(parts)
    if max_out is not None and len(out) > max_out:
        raise DecompressError("lz4 frame output exceeds expected size")
    return out


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------


class ZstdBlock(NamedTuple):
    btype: int
    payload: bytes
    rle_size: int
    #: ("raw", literal bytes) or ("batch", first stream, n streams, n literals);
    #: a raw or RLE block is one literal run
    lits: tuple
    #: where the sequence section starts (compressed blocks)
    lits_end: int
    #: the block's index into ``ZstdWalk.seq_items``; None without sequences
    slot: int | None


class ZstdWalk(NamedTuple):
    frames: list          # (FrameHeader, [ZstdBlock], content checksum or None)
    streams: list         # every Huffman literal stream, in order
    tables: list          # the HuffDecodeTable of each stream
    n_syms: list          # the symbol count of each stream
    seq_items: list       # (bitstream, ll, of, ml table, nb_seq) per block with sequences


def walk_zstd(data: bytes, *, sequences: bool = True) -> ZstdWalk:
    """Walk concatenated zstd frames without decoding an entropy stream:
    frame and block headers, literal-section headers and Huffman tables,
    and (with ``sequences``) the sequence-section headers and FSE tables.
    Copy of the structural walk of ``extract.decompress_zstd_device``
    (``extract.py:275-361``); dictionary frames and reserved block types
    raise DecompressError there and here.  The device route runs it where
    the native walk (:func:`zstd_plan`) is missing or rejects the input."""
    frames: list = []
    streams: list[bytes] = []
    tables: list = []
    n_syms: list[int] = []
    seq_items: list[tuple] = []
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < 4:
            raise DecompressError("truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, pos)
        if zframe.MAGIC_SKIPPABLE_MIN <= magic <= zframe.MAGIC_SKIPPABLE_MAX:
            if n - pos < 8:
                raise DecompressError("truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != zframe.MAGIC:
            raise DecompressError(f"bad zstd magic {magic:#x}")
        pos += 4
        header = zframe.parse_frame_header(data, pos)
        pos += header.header_size
        if header.dict_id:
            raise DecompressError(f"frame requires dictionary {header.dict_id} (none attached)")
        lit_state = zframe.LiteralsState()
        ftables = zseq.SequenceTables()
        blocks = []
        while True:
            if n - pos < 3:
                raise DecompressError("truncated block header")
            bh = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
            pos += 3
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == zframe.BLOCK_RLE:
                payload = data[pos:pos + 1]
                if len(payload) < 1:
                    raise DecompressError("truncated RLE block")
                pos += 1
                blocks.append(ZstdBlock(btype, payload, bsize, ("raw", payload * bsize), 0, None))
            elif btype == zframe.BLOCK_RAW:
                payload = data[pos:pos + bsize]
                if len(payload) < bsize:
                    raise DecompressError("truncated block")
                pos += bsize
                blocks.append(ZstdBlock(btype, payload, 0, ("raw", payload), 0, None))
            elif btype == zframe.BLOCK_COMPRESSED:
                payload = data[pos:pos + bsize]
                if len(payload) < bsize:
                    raise DecompressError("truncated block")
                pos += bsize
                with metrics.phase("torch.zstd_walk.literals", bsize):
                    plan, lits_end = zframe.parse_literals_section(payload, 0, lit_state)
                if plan[0] == "done":
                    lits = ("raw", plan[1])
                else:
                    _, items, table = plan
                    lits = ("batch", len(streams), len(items), sum(c for _, c in items))
                    for s, cnt in items:
                        streams.append(s)
                        tables.append(table)
                        n_syms.append(cnt)
                slot = None
                if sequences:
                    with metrics.phase("torch.zstd_walk.sequences", bsize - lits_end):
                        nb, bs = fse_torch.parse_headers(payload, lits_end, ftables)
                    if nb:
                        slot = len(seq_items)
                        seq_items.append((bs, ftables.ll, ftables.of, ftables.ml, nb))
                blocks.append(ZstdBlock(btype, payload, 0, lits, lits_end, slot))
            else:
                raise DecompressError("reserved block type")
            if last:
                break
        chk = None
        if header.has_checksum:
            if n - pos < 4:
                raise DecompressError("truncated content checksum")
            (chk,) = struct.unpack_from("<I", data, pos)
            pos += 4
        frames.append((header, blocks, chk))
    return ZstdWalk(frames, streams, tables, n_syms, seq_items)


def decompress_zstd_batched(data: bytes, max_out: int | None = None, *, device) -> bytes:
    """One-shot decompress of concatenated zstd frames with every Huffman
    literal stream decoded in one launch on ``device`` and the sequences
    decoded and executed per block on the host
    (``extract.decompress_zstd_batched``; no dictionaries)."""
    w = walk_zstd(data, sequences=False)
    decoded = TorchHuffmanDecoder(device).decode_batch(w.streams, w.tables, w.n_syms)
    out = bytearray()
    for header, blocks, chk in w.frames:
        dec = zframe.FrameDecoder(header)
        for b in blocks:
            lits_pos = None
            if b.btype == zframe.BLOCK_COMPRESSED:
                if b.lits[0] == "raw":
                    lits = b.lits[1]
                else:
                    _, base, cnt, _ = b.lits
                    lits = b"".join(a.tobytes() for a in decoded[base:base + cnt])
                lits_pos = (lits, b.lits_end)
            out += dec.decode_block(b.btype, b.payload, b.rle_size, lits_pos=lits_pos)
        if chk is not None and (dec.hasher.digest() & 0xFFFFFFFF) != chk:
            raise DecompressError("content checksum mismatch")
    if max_out is not None and len(out) > max_out:
        raise DecompressError("zstd output exceeds expected size")
    return bytes(out)


def _literal_layout(w: ZstdWalk):
    """Where every literal goes: frame j's literals fill row j of an
    (F, LB) byte table in block order.  Returns LB, each stream's flat
    destination, and the raw literal runs as (bytes, flat destination)."""
    f_lits = []
    dst = [0] * len(w.streams)
    raw = []
    for j, (_, blocks, _) in enumerate(w.frames):
        lp = 0
        for b in blocks:
            if b.lits[0] == "raw":
                if b.lits[1]:
                    raw.append((b.lits[1], j, lp))
                lp += len(b.lits[1])
            else:
                _, base, cnt, total = b.lits
                sp = lp
                for s in range(base, base + cnt):
                    dst[s] = (j, sp)
                    sp += w.n_syms[s]
                lp += total
        f_lits.append(lp)
    LB = max(max(f_lits, default=0), 1)
    return LB, [j * LB + p for j, p in dst], [(r, j * LB + p) for r, j, p in raw]


def _runs(parts: list[tuple]) -> tuple:
    """Byte runs ``(bytes, flat destination)`` as :func:`_scatter_runs`
    takes them: the runs back to back, and (length, destination, start,
    step 1) a run."""
    lens = np.array([len(p) for p, _ in parts], dtype=np.int64)
    runs = np.stack([lens, np.array([d for _, d in parts], dtype=np.int64),
                     np.cumsum(lens) - lens, np.ones_like(lens)], axis=1).reshape(-1, 4)
    return np.frombuffer(bytearray(b"".join(p for p, _ in parts)), dtype=np.uint8), runs


def _scatter_runs(dst: torch.Tensor, source, runs: np.ndarray) -> None:
    """Write literal runs into the flat ``dst`` (counterpart of
    ``extract._scatter_flat_u8``): run ``(length, destination, start,
    step)`` writes ``source[start + k * step]`` to ``destination + k`` for
    ``k`` below its length (step 1 a raw run, 0 one byte repeated).
    ``source`` is a uint8 array or tensor, on the device or not.  One
    upload of the runs, one gather, one scatter.  The runs are exact, so no
    lane is padding."""
    if not len(runs):
        return
    dev, total = dst.device, int(runs[:, 0].sum())
    with metrics.phase("torch.huffman_decode.wait"):  # blocking uploads
        runs_d, src = torch.from_numpy(runs).to(dev), torch.as_tensor(source).to(dev)
    lens = runs_d[:, 0]
    run_of = torch.repeat_interleave(torch.arange(len(runs), device=dev), lens, output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(lens, 0) - lens)[run_of]
    dst[runs_d[run_of, 1] + k] = src[runs_d[run_of, 2] + k * runs_d[run_of, 3]]


class ZstdPlan(NamedTuple):
    """What the device route needs of an entry's walk, from either walk."""
    frame_chk: list       # each frame's content checksum, or None
    blk_frame: list       # each block's frame
    blk_lits: list        # each block's literal bytes
    blk_slot: list        # each block's sequence item, or -1
    lit_row: int          # LB: frame j's literals fill row j of an (F, LB) table
    n_streams: int        # Huffman streams
    n_syms: int           # their symbols
    #: the Huffman batch (``huffman_torch.build_decode_batch``'s arrays),
    #: given the entry on the device where the batch points into it
    huffman: Callable
    #: the raw and RLE literal runs (:func:`_scatter_runs`), and the bytes
    #: they are read from (None: the entry)
    runs: np.ndarray
    run_source: np.ndarray | None
    n_items: int          # blocks with sequences
    n_seqs: int           # their sequences
    sequences: Callable   # the FSE batch, likewise
    native: bool          # the batches point into the entry


def _python_plan(data: bytes) -> ZstdPlan:
    """The plan of :func:`walk_zstd` and :func:`_literal_layout`; the
    batches are built when asked for, where the decoders need them, so
    their errors keep their order."""
    w = walk_zstd(data)
    with metrics.phase("torch.zstd_walk.layout", len(w.streams)):
        LB, stream_dst, raw_parts = _literal_layout(w)
        blocks = [(j, len(b.lits[1]) if b.lits[0] == "raw" else b.lits[3],
                   -1 if b.slot is None else b.slot)
                  for j, (_, bl, _) in enumerate(w.frames) for b in bl]
        blk_frame, blk_lits, blk_slot = (list(c) for c in zip(*blocks)) if blocks \
            else ([], [], [])
        run_source, runs = _runs(raw_parts)
        return ZstdPlan(
            [chk for _, _, chk in w.frames], blk_frame, blk_lits, blk_slot, LB,
            len(w.streams), sum(w.n_syms),
            lambda entry: huffman_torch.build_decode_batch(w.streams, w.tables, w.n_syms,
                                                           stream_dst),
            runs, run_source, len(w.seq_items), sum(it[4] for it in w.seq_items),
            lambda entry: fse_torch.build_decode_batch(w.seq_items), False)


def _native_plan(lib, data: bytes) -> ZstdPlan | None:
    """The plan of the native walk, or None where it rejects the input."""
    with native.ZstdWalk(lib, data) as nw:
        with metrics.phase("torch.zstd_walk.native", len(data)):
            with metrics.phase("torch.zstd_walk.literals", len(data)):
                lits = nw.literals()
            if lits is None:
                return None
            with metrics.phase("torch.zstd_walk.sequences", len(data)):
                seqs = nw.sequences()
            if seqs is None:
                return None
    with metrics.phase("torch.zstd_walk.layout", len(lits["streams"])):
        streams, blocks = lits["streams"], lits["blocks"]
        huf = {"rows": streams, "tables": lits["tables"],
               "widest": int(streams[:, 1].max(initial=0))}
        fse = {k: seqs[k] for k in ("rows", "seq_off", "al", "tables")}
        return ZstdPlan(
            [None if c < 0 else c for c in lits["frame_chk"].tolist()],
            blocks[:, 0].tolist(), blocks[:, 4].tolist(), seqs["slots"].tolist(),
            lits["lit_row"], len(streams), int(streams[:, 3].sum()),
            lambda entry: {**huf, "payload": entry},
            lits["runs"], None, len(fse["rows"]),
            int(fse["seq_off"][-1]), lambda entry: {**fse, "payload": entry}, True)


def zstd_plan(data: bytes) -> ZstdPlan:
    """Walk concatenated zstd frames for the device route: the native walk
    where the library has it and accepts the input, else :func:`walk_zstd`
    (which then raises its DecompressError, or accepts the input)."""
    lib = native.zstd_walk_lib()
    plan = None if lib is None else _native_plan(lib, data)
    return _python_plan(data) if plan is None else plan


def decompress_zstd_device(data: bytes, max_out: int | None = None, *, device,
                           mesh=None) -> bytes:
    """Decompress concatenated zstd frames with all entropy decoding and
    sequence execution on ``device`` (``extract.decompress_zstd_device``):

    1. host structural walk and tables (:func:`zstd_plan`);
    2. every Huffman literal stream in one launch, each written straight to
       its place in its frame's literal row; raw literal runs scattered in;
    3. every FSE sequence section in one launch;
    4. repeat offsets: per-block totals on the device, the entry states
       stitched on the host frame by frame, then the offsets resolved;
    5. assembly with torch ops: each frame's segments (sequences, plus the
       literal tails and literal-only blocks) in one (F, SB) table, their
       prefix sums, and the check that no match reaches before its frame;
    6. one replay row per frame (``lz4_torch.replay``), then the content
       checksums on the host.

    With ``mesh`` (a ``DeviceMesh``) the Huffman and FSE decode batches of
    steps 2 and 3 shard over its devices, as the JAX function's do over its
    mesh; steps 4 to 6 run on ``device``.

    Raises DecompressError, with the messages of the JAX function, on
    malformed input; the codec then falls back (dictionaries, offset codes
    above 30)."""
    dev = torch.device(device)
    shards = dev if mesh is None else mesh
    with metrics.phase("torch.zstd_walk", len(data)):
        plan = zstd_plan(data)
    F = len(plan.frame_chk)
    LB = plan.lit_row

    with metrics.phase("torch.huffman_decode", plan.n_syms):
        entry = None
        if plan.native and data:
            # the native batches and runs point into the entry: one upload
            with metrics.phase("torch.huffman_decode.wait", len(data)):  # a blocking upload
                entry = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        if plan.n_streams:
            lit_flat, final = TorchHuffmanDecoder(shards).decode_built(plan.huffman(entry),
                                                                       F * LB)
            if (final != 0).any():
                raise DecompressError("huffman stream not fully consumed")
            lit_flat = lit_flat.to(dev)
        else:
            lit_flat = torch.zeros(F * LB, dtype=torch.uint8, device=dev)
        _scatter_runs(lit_flat, entry if plan.run_source is None else plan.run_source,
                      plan.runs)

    B = plan.n_items
    if B:
        with metrics.phase("torch.fse_decode", plan.n_seqs):
            flat, seq_off = fse_torch.TorchSequenceDecoder(shards).decode_built(
                plan.sequences(entry))
            ll_d, ml_d, ov_d = (t.to(dev) for t in flat)
        with metrics.phase("torch.rep_resolve", int(seq_off[-1])):
            with metrics.phase("torch.rep_resolve.wait"):  # a blocking upload
                seq_off_d = torch.from_numpy(seq_off).to(dev)
            totals = fse_torch.rep_totals(ov_d, ll_d, ml_d, seq_off_d)
            with metrics.phase("torch.rep_resolve.wait", sum(t.nbytes for t in totals)):
                tot_sel, tot_val, sums = (t.cpu().numpy() for t in totals)
            entry_rep = np.zeros((B, 3), np.int32)
            frame = -1
            for j, slot in zip(plan.blk_frame, plan.blk_slot):
                if j != frame:  # each frame starts from the initial offsets
                    frame, rep = j, [1, 4, 8]
                if slot >= 0:
                    entry_rep[slot] = rep
                    rep = fse_torch.eval_rep_map(tot_sel[slot], tot_val[slot], rep)
            with metrics.phase("torch.rep_resolve.wait"):  # a blocking upload
                entry_d = torch.from_numpy(entry_rep).to(dev)
            offs_d, err = fse_torch.rep_apply(ov_d, ll_d, seq_off_d, entry_d)
            with metrics.phase("torch.rep_resolve.wait", err.nbytes):
                err = err.cpu().numpy()
            if err.any():
                raise DecompressError("repeat offset underflow")
        sum_ll, sum_ml = sums[:, 0].tolist(), sums[:, 1].tolist()

    with metrics.phase("torch.zstd_assemble", F):
        # host layout: every segment's frame row and column, known from the
        # headers and the per-block sums
        f_nseg, f_total = [], []
        sq_shift = np.zeros(B, np.int64)
        n_seq = np.diff(seq_off).tolist() if B else []
        fixed = []  # literal-only segments: (frame, column, literal length)
        nseg = total = 0
        n_blk = len(plan.blk_frame)
        for i, (j, lt, slot) in enumerate(zip(plan.blk_frame, plan.blk_lits, plan.blk_slot)):
            if slot < 0:
                total += lt
                if lt:
                    fixed.append((j, nseg, lt))
                    nseg += 1
            else:
                tail = lt - sum_ll[slot]
                if tail < 0:
                    raise DecompressError("literal run overruns literals")
                produced = lt + sum_ml[slot]
                if produced > zframe.MAX_BLOCK_SIZE:
                    # a block regenerates at most 128 KiB (RFC 8878)
                    raise DecompressError("block regenerated size too large")
                total += produced
                sq_shift[slot] = nseg  # the frame row's base is added below
                nseg += n_seq[slot]
                if tail:
                    fixed.append((j, nseg, tail))
                    nseg += 1
            if i + 1 == n_blk or plan.blk_frame[i + 1] != j:  # the frame's last block
                f_nseg.append(nseg)
                f_total.append(total)
                nseg = total = 0
                if max_out is not None and sum(f_total) > max_out:
                    raise DecompressError("zstd output exceeds expected size")
        outs = [b""] * F
        if max(f_total, default=0) > 0:
            SB = max(max(f_nseg), 1)
            seg = torch.zeros((3, F * SB), dtype=torch.int32, device=dev)  # ll, ml, off
            if B:
                frame_of = np.array([j for j, slot in zip(plan.blk_frame, plan.blk_slot)
                                     if slot >= 0], np.int64)
                with metrics.phase("torch.zstd_assemble.wait"):  # blocking uploads
                    shift = torch.from_numpy(frame_of * SB + sq_shift - seq_off[:-1]).to(dev)
                    nsq = torch.from_numpy(np.diff(seq_off)).to(dev)
                idx = torch.repeat_interleave(shift, nsq, output_size=int(seq_off[-1])) \
                    + torch.arange(int(seq_off[-1]), device=dev)
                seg[:, idx] = torch.stack([ll_d, ml_d, offs_d])
            if fixed:
                fx = torch.tensor([[j * SB + p, lt] for j, p, lt in fixed], dtype=torch.int64)
                with metrics.phase("torch.zstd_assemble.wait"):  # blocking uploads
                    fx_d = fx[:, 0].to(dev), fx[:, 1].to(torch.int32).to(dev)
                seg[0, fx_d[0]] = fx_d[1]
            # counterpart of extract._seg_prefix_validate
            ll, ml, off = (t.view(F, SB).to(torch.int64) for t in seg)
            seg_len = ll + ml
            seg_st = torch.cumsum(seg_len, 1) - seg_len
            lit_st = torch.cumsum(ll, 1) - ll
            with metrics.phase("torch.zstd_assemble.wait"):  # a blocking upload
                nseg_d = torch.tensor(f_nseg, dtype=torch.int32, device=dev)
            valid = torch.arange(SB, device=dev) < nseg_d[:, None]
            beyond = (valid & (ml > 0) & (off > seg_st + ll)).any()
            with metrics.phase("torch.zstd_assemble.wait", 1):
                beyond = bool(beyond)
            if beyond:
                raise DecompressError("match offset beyond decoded history")

    if max(f_total, default=0) > 0:
        with metrics.phase("torch.replay", sum(f_total)):
            with metrics.phase("torch.replay.wait"):  # a blocking upload
                f_total_d = torch.tensor(f_total, dtype=torch.int32, device=dev)
            rows = lz4_torch.replay(
                lit_flat.view(F, LB), seg_st.to(torch.int32), lit_st.to(torch.int32),
                seg[0].view(F, SB), seg[2].view(F, SB), nseg_d, f_total_d, n_out=max(f_total))
            with metrics.phase("torch.replay.wait", rows.nbytes):
                rows = rows.cpu().numpy()
            outs = [rows[j, :t].tobytes() for j, t in enumerate(f_total)]

    with metrics.phase("torch.zstd_checksum", sum(f_total)):
        for chk, fb in zip(plan.frame_chk, outs):
            if chk is not None and (XXH64State(0).update(fb).digest() & 0xFFFFFFFF) != chk:
                raise DecompressError("content checksum mismatch")
    with metrics.phase("torch.zstd_join", sum(f_total)):
        result = b"".join(outs)
    if max_out is not None and len(result) > max_out:
        raise DecompressError("zstd output exceeds expected size")
    return result
