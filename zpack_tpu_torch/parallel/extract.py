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
  and builds the decode tables (:func:`zstd_plan`), then the device decodes
  every Huffman literal stream, every FSE sequence section and every repeat
  offset, the assembly lays the sequences out per frame, and each frame
  replays as one row of the LZ4 replayer.  On a ``DecompressError`` the
  codec takes one step down, to the host decoders.

The walk is the native one (``native/zstd_walk.cpp``, two calls an entry)
where the library has it and accepts the input.  The Python walk
(:func:`walk_zstd`) stays beside it: it is the only walk where the native
library is absent (``--engine python``, a host with no compiler), and the
reference the native walk is held to.  Both fill the same
:class:`ZstdPlan`.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..codecs.lz4 import frame as lz4f
from ..codecs.xxh3 import XXH32State, XXH64State, xxh32
from ..codecs.zstd import frame as zframe, seq as zseq
from ..errors import DecompressError
from ..utils.observe import metrics

from ..kernels import assemble_torch, fse_torch, huffman_torch, lz4_torch, zstd_chain
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


def walk_zstd(data: bytes) -> ZstdWalk:
    """Walk concatenated zstd frames without decoding an entropy stream:
    frame and block headers, literal-section headers and Huffman tables,
    and the sequence-section headers and FSE tables.
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
    """Byte runs ``(bytes, flat destination)`` as the assembly's layout
    takes them: the runs back to back, and (length, destination, start,
    step 1) a run."""
    lens = np.array([len(p) for p, _ in parts], dtype=np.int64)
    runs = np.stack([lens, np.array([d for _, d in parts], dtype=np.int64),
                     np.cumsum(lens) - lens, np.ones_like(lens)], axis=1).reshape(-1, 4)
    return np.frombuffer(bytearray(b"".join(p for p, _ in parts)), dtype=np.uint8), runs


class ZstdPlan(NamedTuple):
    """What the device route needs of an entry's walk; both walks fill it
    alike."""
    frame_chk: list       # each frame's content checksum, or None
    frame_size: np.ndarray  # (F,) int64: each frame's declared content size, or -1
    blocks: np.ndarray    # (NB, 3) int64: each block's frame, literal bytes, sequence item or -1
    lit_row: int          # LB: frame j's literals fill row j of an (F, LB) table
    #: (N,) uint8: the bytes every Huffman row, FSE row and literal run indexes
    source: np.ndarray
    #: the Huffman batch (``rows``, ``tables``, ``widest``), or None
    huffman: dict | None
    #: the FSE batch (``rows``, ``seq_off``, ``al``, ``tables``), or None
    sequences: dict | None
    #: the raw and RLE literal runs (length, destination, source, step)
    runs: np.ndarray
    #: the FSE batch's own error, raised after the Huffman check
    error: DecompressError | None


def _python_plan(data: bytes) -> ZstdPlan:
    """The plan of :func:`walk_zstd`, :func:`_literal_layout` and the two
    ``build_decode_batch``s: ``source`` is the Huffman streams, the FSE
    bitstreams and the raw literal runs back to back.  The FSE batch's
    error waits in ``error``, so the errors keep their order."""
    w = walk_zstd(data)
    with metrics.phase("torch.zstd_walk.layout", len(w.streams)):
        LB, stream_dst, raw_parts = _literal_layout(w)
        blocks = np.array([(j, len(b.lits[1]) if b.lits[0] == "raw" else b.lits[3],
                            -1 if b.slot is None else b.slot)
                           for j, (_, bl, _) in enumerate(w.frames) for b in bl],
                          dtype=np.int64).reshape(-1, 3)
        run_bytes, runs = _runs(raw_parts)
        size = [-1 if h.content_size is None or h.content_size >= 2**63 else h.content_size
                for h, _, _ in w.frames]
        parts, huf, fse, error = [], None, None, None
        if w.streams:
            batch = huffman_torch.build_decode_batch(w.streams, w.tables, w.n_syms, stream_dst)
            huf = {k: batch[k] for k in ("rows", "tables", "widest")}
            parts.append(batch["payload"])
        if w.seq_items:
            try:
                batch = fse_torch.build_decode_batch(w.seq_items)
            except DecompressError as e:
                error = e
            else:  # its rows move past the Huffman streams
                fse = {k: batch[k] for k in ("seq_off", "al", "tables")}
                fse["rows"] = batch["rows"] + [sum(map(len, parts)), 0, 0]
                parts.append(batch["payload"])
        runs[:, 2] += sum(map(len, parts))
        return ZstdPlan(
            [chk for _, _, chk in w.frames], np.array(size, dtype=np.int64), blocks, LB,
            np.concatenate(parts + [run_bytes]), huf, fse, runs, error)


def _native_plan(lib, data: bytes) -> ZstdPlan | None:
    """The plan of the native walk, or None where it rejects the input:
    ``source`` is the entry itself."""
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
               "widest": int(streams[:, 1].max(initial=0))} if len(streams) else None
        fse = {k: seqs[k] for k in ("rows", "seq_off", "al", "tables")} \
            if len(seqs["rows"]) else None
        return ZstdPlan(
            [None if c < 0 else c for c in lits["frame_chk"].tolist()], lits["frame_size"],
            np.stack([blocks[:, 0], blocks[:, 4], seqs["slots"]], axis=1), lits["lit_row"],
            np.frombuffer(data, dtype=np.uint8), huf, fse, lits["runs"], None)


def zstd_plan(data: bytes) -> ZstdPlan:
    """Walk concatenated zstd frames for the device route: the native walk
    where the library has it and accepts the input, else :func:`walk_zstd`
    (which then raises its DecompressError, or accepts the input)."""
    lib = native.zstd_walk_lib()
    plan = None if lib is None else _native_plan(lib, data)
    return _python_plan(data) if plan is None else plan


#: bytes between the arrays of one staged upload
STAGE_ALIGN = 256


def stage(arrays: dict, device) -> dict:
    """The host arrays ``arrays`` (name: numpy array or bytes) on
    ``device`` as tensors of their dtypes and shapes.  On a GPU they are
    packed, each at a multiple of :data:`STAGE_ALIGN` bytes, into one
    pinned buffer and sent up in one non-blocking copy; each tensor is a
    view of the one device buffer.  The pinned buffer comes from PyTorch's
    caching host allocator, which hands it out again only once the copy has
    landed, so a later call never overwrites an upload in flight.  On the
    CPU each is its array, copied where numpy holds it read-only."""
    arrays = {k: np.frombuffer(v, np.uint8) if isinstance(v, (bytes, bytearray)) else v
              for k, v in arrays.items()}
    if device.type == "cpu":
        return {k: torch.from_numpy(a if a.flags.writeable else a.copy())
                for k, a in arrays.items()}
    places, pos = stage_places(arrays)
    host = torch.empty(max(pos, 1), dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    for k, a in arrays.items():
        view[places[k]:places[k] + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {k: dev[places[k]:places[k] + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
            for k, a in arrays.items()}


def stage_places(arrays: dict) -> tuple[dict, int]:
    """Where :func:`stage` packs each of ``arrays`` (name: numpy array),
    in bytes from the upload's start, and the upload's bytes."""
    places, pos = {}, 0
    for k, a in arrays.items():
        places[k] = pos
        pos += -(-a.nbytes // STAGE_ALIGN) * STAGE_ALIGN
    return places, pos


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool}


def predicted_sizes(plan: ZstdPlan, max_out: int | None) -> np.ndarray | None:
    """Each frame's output size as its header declares it, where every
    frame declares one its blocks can hold (raw and RLE blocks and blocks
    of literals alone their bytes, a block with sequences 128 KiB) and the
    frames fit ``max_out``; else None, and the read takes the exact path,
    which reads the sizes back before the replay."""
    F, blk = len(plan.frame_chk), plan.blocks
    if not F or (plan.frame_size < 0).any():
        return None
    room = np.bincount(blk[:, 0], np.where(blk[:, 2] < 0, blk[:, 1], assemble_torch.MAX_BLOCK),
                       minlength=F)
    if (plan.frame_size > room).any():
        return None
    if max_out is not None and int(plan.frame_size.sum()) > max_out:
        return None
    return plan.frame_size


def _frame_offsets(sizes: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def _read_back(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: on a GPU one copy into pinned memory, which waits
    for the card; on the CPU the tensor's own memory."""
    if t.device.type == "cpu":
        return t.numpy()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t).numpy()


def decompress_zstd_device(data: bytes, max_out: int | None = None, *, device,
                           mesh=None) -> bytes:
    """Decompress concatenated zstd frames with all entropy decoding and
    sequence execution on ``device`` (``extract.decompress_zstd_device``),
    waiting on the device once:

    1. host structural walk and tables (:func:`zstd_plan`), and what the
       host knows from them: each block's frame, literal bytes and
       sequence item, the segment table's width, each frame's declared
       size (:func:`predicted_sizes`);
    2. all of it, with the plan's ``source`` (on the native walk the entry
       itself), up in one pinned copy;
    3. every Huffman literal stream in one launch, each written straight to
       its place in its frame's literal row;
    4. every FSE sequence section in one launch;
    5. repeat offsets: per-block totals (``fse_torch.rep_totals``), the
       entry states stitched frame by frame on the device
       (``assemble_torch.stitch``, which also places every block and makes
       every layout check), then the offsets resolved
       (``fse_torch.rep_apply``);
    6. the layout (``assemble_torch.layout``): each frame's segments in one
       (F, SB) table, the "beyond decoded history" check, the raw literal
       runs copied in;
    7. one replay row per frame (``lz4_torch.replay_enqueue``), the rows
       trimmed to the declared sizes behind the record of every check
       (``assemble_torch.trim``), one read-back into pinned memory; then
       the errors in the order the checks run, the content checksums, and
       one copy into the returned bytes.

    A frame with no declared size (or one its blocks cannot hold) sends the
    read to the exact path: the record and sizes are read back after step
    6, then the replay; a declared size the device finds wrong replays
    again at the computed sizes.  Both count ``torch.zstd_resize`` and give
    the same bytes and errors.

    Three routes run steps 2 to 7, chosen by the device and the mesh alone:

    * on a GPU (``mesh`` None), :func:`_decode_native`: sizes, upload and
      launch chain from native code (``kernels/zstd_chain.py``), one phase
      ``torch.zstd_enqueue``;
    * on the CPU, :func:`_decode_python`: the same steps through the
      wrappers' plain versions (and on a GPU where the native library is
      missing, through the wrappers' kernels);
    * with ``mesh`` (a ``DeviceMesh``), :func:`_decode_mesh`: the Huffman
      and FSE decode batches of steps 3 and 4 shard over its devices, as
      the JAX function's do over its mesh, each checked where it runs; the
      rest runs on ``device`` as on the Python route.

    Raises DecompressError, with the messages of the JAX function and in
    its order, on malformed input and on what the device does not decode
    (offset codes above 30); the codec then takes its one step down, to the
    host decoders, counted as ``device_to_host``."""
    dev = torch.device(device)
    with metrics.phase("torch.zstd_walk", len(data)):
        plan = zstd_plan(data)
    result = b""
    if plan.frame_chk:
        if mesh is not None:
            result = _decode_mesh(plan, max_out, dev, mesh)
        elif dev.type == "cuda" and plan.error is None and native.zstd_read_lib() is not None:
            result = _decode_native(plan, max_out, dev)
        else:  # a plan with an error raises it there, after the Huffman check
            result = _decode_python(plan, max_out, dev)
    if max_out is not None and len(result) > max_out:
        raise DecompressError("zstd output exceeds expected size")
    return result


class ReadShape(NamedTuple):
    """What the host computes of a read before its upload (step 1)."""
    frame_first: np.ndarray  # (F + 1,) int64: each frame's first block, NB last
    sizes: np.ndarray | None  # the declared sizes, or None: the exact path
    cap: int                 # the longest frame the replay may take


def read_shape(plan: ZstdPlan, max_out: int | None) -> ReadShape:
    """The read's :class:`ReadShape` in numpy."""
    F, blk = len(plan.frame_chk), plan.blocks
    sizes = predicted_sizes(plan, max_out)
    return ReadShape(np.searchsorted(blk[:, 0], np.arange(F + 1)), sizes,
                     int(sizes.max()) if sizes is not None else assemble_torch.NONE)


def segment_width(plan: ZstdPlan) -> int:
    """The segment table's width: a frame's sequences plus a segment a
    block, for its literal tail or its literals alone (a plan whose FSE
    batch failed has raised before this is asked)."""
    F, blk = len(plan.frame_chk), plan.blocks
    slot = blk[:, 2]
    per_block = np.ones(len(blk), np.int64)
    per_block[slot >= 0] += np.diff(_seq_off(plan))[slot[slot >= 0]]
    return max(int(np.bincount(blk[:, 0], per_block, minlength=F).max()), 1)


def _seq_off(plan: ZstdPlan) -> np.ndarray:
    return plan.sequences["seq_off"] if plan.sequences is not None else np.zeros(1, np.int64)


def uploads(plan: ZstdPlan, shape: ReadShape, entropy: bool = True) -> dict:
    """The host arrays of the read's one upload, in order; the decoders'
    rows and tables only with ``entropy`` (the mesh's shards upload their
    own)."""
    F, huf, fse = len(plan.frame_chk), plan.huffman, plan.sequences
    up = {"blk": plan.blocks, "frame_first": shape.frame_first, "seq_off": _seq_off(plan),
          "runs": plan.runs,
          "declared": shape.sizes if shape.sizes is not None else np.full(F, -1, np.int64)}
    if shape.sizes is not None:
        up["offsets"] = _frame_offsets(shape.sizes)
    up["source"] = plan.source
    if entropy:
        if huf is not None:
            up.update({f"huf_{k}": huf[k] for k in ("rows", "tables")})
        if fse is not None:
            up.update({f"fse_{k}": fse[k] for k in ("rows", "al", "tables")})
    return up


def _no_sequences(dev) -> tuple:
    """The FSE decode's outputs for a read with no sequence section."""
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return empty, empty, empty, empty, torch.zeros(0, dtype=torch.bool, device=dev)


def _decode_python(plan: ZstdPlan, max_out, dev) -> bytes:
    """Steps 2 to 7 through the wrappers on ``dev``: the CPU route, with
    their plain versions; on a GPU, with their kernels, a plan whose FSE
    batch failed (it raises after the Huffman check) and a host without the
    native library."""
    F, huf, fse = len(plan.frame_chk), plan.huffman, plan.sequences
    shape = read_shape(plan, max_out)
    up = uploads(plan, shape)
    with metrics.phase("torch.zstd_stage", sum(v.nbytes for v in up.values())):
        d = stage(up, dev)
    with metrics.phase("torch.huffman_decode",
                       0 if huf is None else int(huf["rows"][:, 3].sum())):
        if huf is None:
            lit_flat = torch.zeros(F * plan.lit_row, dtype=torch.uint8, device=dev)
            final = torch.zeros(0, dtype=torch.int32, device=dev)
        else:
            lit_flat, final = huffman_torch.decode_streams(
                d["source"], d["huf_rows"], d["huf_tables"], n_out=F * plan.lit_row,
                widest=huf["widest"])
        if plan.error is not None:  # no FSE batch: the Huffman check, then its error
            with metrics.phase("torch.huffman_decode.wait", final.nbytes):
                if bool((final != 0).any()):
                    raise DecompressError("huffman stream not fully consumed")
            raise plan.error
    seqs = _no_sequences(dev)
    if fse is not None:
        with metrics.phase("torch.fse_decode", int(fse["seq_off"][-1])):
            seqs = fse_torch.decode_seq_streams(
                d["source"], d["fse_rows"], d["seq_off"], d["fse_al"], d["fse_tables"],
                shape=fse_torch.decode_shape(fse["rows"], fse["seq_off"]))
    return _assemble(plan, max_out, dev, shape, d, lit_flat, final, seqs)


def _decode_mesh(plan: ZstdPlan, max_out, dev, mesh) -> bytes:
    """Steps 2 to 7 with the Huffman and FSE batches sharded over ``mesh``:
    each shard has its own uploads and read-back, so its checks run where
    it runs, and its errors come in item order."""
    F, huf, fse = len(plan.frame_chk), plan.huffman, plan.sequences
    shape = read_shape(plan, max_out)
    up = uploads(plan, shape, entropy=False)
    with metrics.phase("torch.zstd_stage", sum(v.nbytes for v in up.values())):
        d = stage(up, dev)
    final = torch.zeros(0, dtype=torch.int32, device=dev)
    with metrics.phase("torch.huffman_decode",
                       0 if huf is None else int(huf["rows"][:, 3].sum())):
        if huf is None:
            lit_flat = torch.zeros(F * plan.lit_row, dtype=torch.uint8, device=dev)
        else:
            lit_flat, fin = TorchHuffmanDecoder(mesh).decode_built(
                {**huf, "payload": d["source"]}, F * plan.lit_row)
            if (fin != 0).any():
                raise DecompressError("huffman stream not fully consumed")
            lit_flat = lit_flat.to(dev)
        if plan.error is not None:
            raise plan.error
    seqs = _no_sequences(dev)
    if fse is not None:
        B = len(fse["rows"])
        with metrics.phase("torch.fse_decode", int(fse["seq_off"][-1])):
            flat, _ = fse_torch.TorchSequenceDecoder(mesh).decode_built(
                {**fse, "payload": d["source"]})
            seqs = (*(t.to(dev) for t in flat), torch.zeros(B, dtype=torch.int32, device=dev),
                    torch.zeros(B, dtype=torch.bool, device=dev))
    return _assemble(plan, max_out, dev, shape, d, lit_flat, final, seqs)


def _assemble(plan: ZstdPlan, max_out, dev, shape: ReadShape, d: dict, lit_flat, final,
              seqs: tuple) -> bytes:
    """Steps 5 to 7 through the wrappers, from the decoders' outputs
    ``lit_flat``, ``final`` and ``seqs`` (``lls, mls, ovs, pos_f, ferr``)."""
    F, LB, SB = len(plan.frame_chk), plan.lit_row, segment_width(plan)
    lls, mls, ovs, pos_f, ferr = seqs
    B, n_seqs, i32 = len(d["seq_off"]) - 1, lls.numel(), torch.int32
    sizes, seq_d = shape.sizes, d["seq_off"]
    rec = assemble_torch.new_record(F, dev)
    max_o = -1 if max_out is None else max_out

    def stitch(declared, cap):
        return assemble_torch.stitch(d["blk"], d["frame_first"], seq_d, sel, val, sums, final,
                                     pos_f, ferr, declared, rec, max_out=max_o, cap=cap)

    if B:
        with metrics.phase("torch.rep_resolve", n_seqs):
            sel, val, sums = fse_torch.rep_totals(ovs, lls, mls, seq_d)
    else:
        sel = val = torch.zeros((0, 3), dtype=i32, device=dev)
        sums = torch.zeros((0, 2), dtype=torch.int64, device=dev)
    with metrics.phase("torch.zstd_assemble", F):
        entry_rep, bases, frame_out = stitch(d["declared"], shape.cap)
    if B:  # the offsets from the entry states the stitch composed
        with metrics.phase("torch.rep_resolve", 0):
            offs, rep_err = fse_torch.rep_apply(ovs, lls, seq_d, entry_rep)
    else:
        offs, rep_err = lls, ferr

    with metrics.phase("torch.zstd_assemble", 0):
        seg = assemble_torch.layout(
            d["blk"], d["frame_first"], bases, seq_d, lls, mls, offs, sums, rep_err, rec, SB=SB,
            runs=d["runs"], run_src=d["source"], lits=lit_flat)
        if sizes is None:  # the exact path: the sizes first
            metrics.count("torch.zstd_resize")
            with metrics.phase("torch.zstd_assemble.wait", rec.nbytes):
                head = _read_back(rec)
            err = assemble_torch.first_error(head)
            if err is not None:
                raise err
            sizes = assemble_torch.record_sizes(head).copy()
            d["offsets"] = stage({"offsets": _frame_offsets(sizes)}, dev)["offsets"]

    def replay_and_read(frame_out, offsets, sizes):
        total, n_out = int(sizes.sum()), int(sizes.max())
        with metrics.phase("torch.replay", total):
            rows, state = lz4_torch.replay_enqueue(
                lit_flat.view(F, LB), *(t.view(F, SB) for t in seg), frame_out[0], frame_out[1],
                n_out=n_out) if n_out else (None, None)
            out = assemble_torch.trim(rows, offsets, state, rec, total=total)
            with metrics.phase("torch.replay.wait", out.nbytes):
                view = _read_back(out)
            return view[:4 * rec.numel()].view(np.int32), view[4 * rec.numel():]

    head, flat = replay_and_read(frame_out, d["offsets"], sizes)
    err = assemble_torch.first_error(head)
    if err is not None:
        raise err
    if head[assemble_torch.REC_RESIZE]:  # a declared size was wrong: replay at the computed
        sizes = assemble_torch.record_sizes(head).copy()
        with metrics.phase("torch.zstd_assemble", F):
            metrics.count("torch.zstd_resize")
            _, _, frame_out = stitch(torch.full((F,), -1, dtype=torch.int64, device=dev),
                                     assemble_torch.NONE)
            offsets = stage({"offsets": _frame_offsets(sizes)}, dev)["offsets"]
        head, flat = replay_and_read(frame_out, offsets, sizes)
    return _finish(plan, sizes, head, flat)


def _decode_native(plan: ZstdPlan, max_out, dev) -> bytes:
    """Steps 2 to 7 on a GPU from native code (``kernels/zstd_chain.py``):
    the layout in one host call, then in the phase ``torch.zstd_enqueue``
    one pinned buffer, the upload packed into it in one call, one arena
    from the caching allocator, and the whole chain, read-back included, in
    one call; then the one wait.  The exact path reads the record back
    after part A, then runs part B on a buffer sized for the computed
    sizes; a wrong declared size runs the stitch again and part B.  Every
    buffer lives until the stream has passed its last use."""
    F = len(plan.frame_chk)
    lay = zstd_chain.Layout(plan, max_out)
    exact, rec_words = lay["EXACT"], lay["REC_WORDS"]
    stream = torch.cuda.current_stream(dev)
    arenas = []  # part B's device buffers

    def part_b(parts, sizes):
        """Part B (after ``parts``) at the computed ``sizes``: its buffers,
        the frames' offsets up, the read-back into a pinned buffer, which it
        returns."""
        lay.replay(sizes)
        pinned_b = torch.empty(lay["PIN_BYTES"], dtype=torch.uint8, pin_memory=True)
        pinned_b.numpy()[:8 * (F + 1)].view(np.int64)[:] = _frame_offsets(sizes)
        arena_b = torch.empty(lay["B_BYTES"], dtype=torch.uint8, device=dev)
        zstd_chain.enqueue(lay, parts | zstd_chain.PART_B, pinned, arena,
                           part_b=arena_b.data_ptr(), offsets=pinned_b,
                           back=pinned_b.data_ptr() + lay["PIN_BACK"])
        arenas.append(arena_b)
        return pinned_b

    def read(buf):
        view = buf.numpy()[lay["PIN_BACK"]:lay["PIN_BACK"] + lay["BACK_BYTES"]]
        return view[:4 * rec_words].view(np.int32), view[4 * rec_words:]

    try:
        with metrics.phase("torch.zstd_enqueue", lay["UP_BYTES"]):
            pinned = torch.empty(lay["PIN_BYTES"], dtype=torch.uint8, pin_memory=True)
            lay.pack(pinned)
            arena = torch.empty(lay["A_BYTES"] + (0 if exact else lay["B_BYTES"]),
                                dtype=torch.uint8, device=dev)
            zstd_chain.enqueue(lay, zstd_chain.PART_A | (0 if exact else zstd_chain.PART_B),
                               pinned, arena, back=pinned.data_ptr() + lay["PIN_BACK"])
            back = pinned
            sizes = plan.frame_size
            if exact:  # the sizes first
                with metrics.phase("torch.zstd_assemble", F):
                    metrics.count("torch.zstd_resize")
                    with metrics.phase("torch.zstd_assemble.wait", 4 * rec_words):
                        stream.synchronize()
                    head, _ = read(pinned)
                    err = assemble_torch.first_error(head)
                    if err is not None:
                        raise err
                    sizes = assemble_torch.record_sizes(head).copy()
                    back = part_b(0, sizes)
            with metrics.phase("torch.zstd_enqueue.wait", lay["BACK_BYTES"]):
                stream.synchronize()
        head, flat = read(back)
        err = assemble_torch.first_error(head)
        if err is not None:
            raise err
        if head[assemble_torch.REC_RESIZE]:  # a declared size was wrong: replay at the computed
            sizes = assemble_torch.record_sizes(head).copy()
            with metrics.phase("torch.zstd_assemble", F):
                metrics.count("torch.zstd_resize")
                back = part_b(zstd_chain.PART_RESTITCH, sizes)
                with metrics.phase("torch.zstd_assemble.wait", lay["BACK_BYTES"]):
                    stream.synchronize()
            head, flat = read(back)
    except BaseException:
        stream.synchronize()  # nothing of this read may still use its buffers
        raise
    return _finish(plan, sizes, head, flat)


def _finish(plan: ZstdPlan, sizes: np.ndarray, head: np.ndarray, flat: np.ndarray) -> bytes:
    """The replay's own error, the content checksums, and the output's one
    copy into bytes, from the read-back's record ``head`` and bytes
    ``flat``."""
    if head[assemble_torch.REC_REPLAY]:
        raise RuntimeError(lz4_torch.REPLAY_UNRESOLVED)
    bounds = _frame_offsets(sizes).tolist()
    with metrics.phase("torch.zstd_checksum", len(flat)):
        for chk, a, b in zip(plan.frame_chk, bounds[:-1], bounds[1:]):
            if chk is not None and \
                    (XXH64State(0).update(memoryview(flat[a:b])).digest() & 0xFFFFFFFF) != chk:
                raise DecompressError("content checksum mismatch")
    with metrics.phase("torch.zstd_join", len(flat)):
        return flat.tobytes()
