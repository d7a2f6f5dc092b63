"""zstd Huffman literal streams for PyTorch: encode and decode.

Counterpart of ``zpack_tpu/kernels/huffman_jax.py``: the encode half
(``_encode_one_stream`` / ``encode_streams`` and ``DeviceHuffmanEncoder``)
and the decode half (``decode_streams_scan`` / ``decode_streams`` and
``DeviceHuffmanDecoder``).  Each kernel has two halves:

* a plain PyTorch version (``encode_streams_plain``,
  ``decode_streams_plain``) that states the contract and runs on any device;
* a wrapper (``encode_streams``, ``decode_streams``) that takes the plain
  version for a tensor on the CPU and launches the hand-written CUDA kernel
  (``csrc/huffman_encode.cu``, ``csrc/huffman_decode.cu``) for a tensor on
  a GPU.  It never falls back: a build or launch error raises.

The encode contract is ``codecs/zstd/huffman.py:_encode_stream``'s.  A
batch is one flat uint8 symbol buffer with ``(start, n)`` rows, one
``(256,)`` table per stream packed as ``code | len << 16``, and the first
word of each stream's output in one flat u32 plane (``word_off``).  In
stream ``s``, symbol ``i`` occupies bits ``[total_bits -
incl_cumsum(len)[i], +len[i])`` of its little-endian plane, so symbol 0
sits highest, and the sentinel bit sits at ``total_bits``.  The planes are
returned in an int32 tensor.

The decode contract is ``huffman._decode_one_stream``'s, layout in
:func:`decode_streams_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..errors import CompressError, DecompressError

from . import _build

#: zstd huffman code-length limit (RFC 8878 §4.2.1)
MAX_BITS = 11
_M32 = 0xFFFFFFFF

#: launches of each hand-written kernel, counted by its wrapper only
LAUNCHES = {"huffman_encode": 0, "huffman_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scatter_bits(n_words: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """OR bit fields into a little-endian u32 plane of ``n_words`` words:
    field ``i``, a value under 2^32 already cut to its width, starts at
    absolute bit ``pos[i]``.  The fields must not share a bit, so a
    scatter-add is an OR.  Returns the plane as int32 (u32 bits)."""
    v = vals.to(torch.int64) << (pos & 31)
    w = pos >> 5
    plane = torch.zeros(n_words + 1, dtype=torch.int64, device=pos.device)
    plane.scatter_add_(0, w, v & _M32)
    plane.scatter_add_(0, w + 1, v >> 32)  # the spill; index n_words is dropped
    plane = plane[:n_words]
    return torch.where(plane > 0x7FFFFFFF, plane - (1 << 32), plane).to(torch.int32)


def pack_tables(tables) -> np.ndarray:
    """``(S, 256)`` int32 ``code | len << 16`` rows from
    ``codecs.zstd.huffman.HuffEncodeTable``s (symbols past a table's end
    have length 0)."""
    out = np.zeros((len(tables), 256), dtype=np.int64)
    for i, t in enumerate(tables):
        lens = np.asarray(t.lengths, dtype=np.int64)
        if (lens > MAX_BITS).any():
            raise CompressError(f"huffman code length above {MAX_BITS}")
        codes = np.asarray(t.codes, dtype=np.int64) & 0xFFFF
        out[i, : len(codes)] = codes
        out[i, : len(lens)] |= lens << 16
    return out.astype(np.int32)


def _check(syms, rows, tables, word_off) -> None:
    S = rows.shape[0]
    if syms.dtype != torch.uint8 or syms.dim() != 1:
        raise ValueError("syms must be a flat uint8 tensor")
    if rows.dtype != torch.int64 or rows.shape != (S, 2):
        raise ValueError("rows must be (S, 2) int64 (start, n)")
    if tables.dtype != torch.int32 or tables.shape != (S, 256):
        raise ValueError("tables must be (S, 256) int32 code | len << 16")
    if word_off.dtype != torch.int64 or word_off.shape != (S + 1,):
        raise ValueError("word_off must be (S + 1,) int64")


def encode_streams_plain(syms, rows, tables, word_off, *, n_words: int):
    """Batched Huffman stream encode in plain PyTorch.

    syms: flat uint8; rows: (S, 2) int64 ``(start, n)``; tables: (S, 256)
    int32 ``code | len << 16``; word_off: (S + 1,) int64, stream ``s``
    owning words ``[word_off[s], word_off[s + 1])`` of the plane.  Returns
    ``(words (n_words,) int32, total_bits (S,) int32)``; words no stream
    reaches stay zero."""
    _check(syms, rows, tables, word_off)
    dev = syms.device
    S = rows.shape[0]
    n = rows[:, 1]
    sid = torch.repeat_interleave(torch.arange(S, device=dev), n)
    local = torch.arange(sid.numel(), device=dev) - (torch.cumsum(n, 0) - n)[sid]
    entry = tables.to(torch.int64)[sid, syms[rows[sid, 0] + local].to(torch.int64)]
    lens = entry >> 16
    codes = entry & ((1 << lens) - 1)
    total = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(0, sid, lens)
    incl = torch.cumsum(lens, 0) - (torch.cumsum(total, 0) - total)[sid]
    base = word_off[:-1] * 32
    pos = torch.cat([base[sid] + total[sid] - incl, base + total])
    vals = torch.cat([codes, torch.ones_like(total)])  # codes, then sentinels
    return scatter_bits(n_words, pos, vals), total.to(torch.int32)


def encode_streams(syms, rows, tables, word_off, *, n_words: int):
    """:func:`encode_streams_plain` on the CPU; on a GPU, the CUDA encoder
    (``csrc/huffman_encode.cu``).  Same inputs, same outputs."""
    if syms.device.type == "cpu":
        return encode_streams_plain(syms, rows, tables, word_off, n_words=n_words)
    if syms.device.type != "cuda":
        raise ValueError("encode_streams takes CPU or CUDA tensors")
    _check(syms, rows, tables, word_off)
    for name, t in (("syms", syms), ("rows", rows), ("tables", tables), ("word_off", word_off)):
        if t.device != syms.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {syms.device}")
    S = rows.shape[0]
    words = torch.zeros(n_words, dtype=torch.int32, device=syms.device)
    total = torch.empty(S, dtype=torch.int32, device=syms.device)
    if S == 0:
        return words, total
    lib = _build.lib()
    with torch.cuda.device(syms.device):
        rc = lib.zp_huffman_encode(
            syms.data_ptr(), rows.data_ptr(), tables.data_ptr(), word_off.data_ptr(), S,
            words.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(syms.device).cuda_stream)
    _build.check(rc, "huffman_encode")
    LAUNCHES["huffman_encode"] += 1
    return words, total


def build_batch(streams: list[np.ndarray], tables) -> dict:
    """The flat batch of :func:`encode_streams` as numpy arrays (``syms``,
    ``rows``, ``tables``, ``word_off``), plus ``n_words`` and each stream's
    ``total_bits``, counted here from its histogram; each stream owns the
    words of its payload and sentinel.  Raises CompressError, as
    ``huffman._encode_stream`` does, when a stream holds a symbol its table
    has no code for."""
    streams = [np.asarray(s, dtype=np.uint8) for s in streams]
    tabs = pack_tables(tables)
    lens = (tabs >> 16).astype(np.int64)
    total = np.zeros(len(streams), dtype=np.int64)
    for i, s in enumerate(streams):
        hist = np.bincount(s, minlength=256)
        if (hist[lens[i] == 0] > 0).any():
            raise CompressError("huffman table misses a packed symbol")
        total[i] = hist @ lens[i]
    counts = np.array([len(s) for s in streams], dtype=np.int64)
    word_off = np.concatenate([[0], np.cumsum((total + 1 + 31) // 32)]).astype(np.int64)
    return {"syms": np.concatenate(streams),
            "rows": np.stack([np.cumsum(counts) - counts, counts], axis=1),
            "tables": tabs, "word_off": word_off, "n_words": int(word_off[-1]),
            "total_bits": total}


#: the tensor arguments of :func:`encode_streams`, in order
BATCH_ARGS = ("syms", "rows", "tables", "word_off")


class TorchHuffmanEncoder:
    """Host wrapper: pack literal streams into one flat batch, encode it on
    ``device`` in one launch, cut the payloads (each identical to
    ``huffman._encode_stream``).  The device analog of
    ``huffman_jax.DeviceHuffmanEncoder``; ``encode_literal_sections``
    takes either."""

    def __init__(self, device):
        self.device = torch.device(device)

    def encode_batch(self, streams: list[np.ndarray], tables) -> list[bytes]:
        """streams[i]: uint8 symbol array; tables[i]: HuffEncodeTable for
        stream i.  Returns the encoded byte payload of each stream."""
        if not streams:
            return []
        batch = build_batch(streams, tables)
        words, total = encode_streams(
            *(torch.from_numpy(batch[k]).to(self.device) for k in BATCH_ARGS),
            n_words=batch["n_words"])
        total_bits = batch["total_bits"]
        if not np.array_equal(total.cpu().numpy(), total_bits):
            raise RuntimeError("huffman_encode: total_bits disagree with the host's count")
        plane = words.cpu().numpy().tobytes()
        off = batch["word_off"]
        return [plane[4 * int(off[i]): 4 * int(off[i]) + (int(total_bits[i]) + 8) // 8]
                for i in range(len(streams))]

    def encode_4stream_batch(self, lit_blocks: list[np.ndarray], tables) -> list[bytes | None]:
        """Device analog of ``huffman.encode_4stream`` for a batch of blocks:
        each block's literals split into 4 sub-streams, all encoded in one
        launch; jump table and concatenation on the host.  ``None`` where a
        part is empty or one of the first three exceeds 0xFFFF bytes."""
        streams, owner, plan = [], [], []
        for bi, arr in enumerate(lit_blocks):
            n = len(arr)
            per = (n + 3) // 4
            parts = [arr[:per], arr[per:2 * per], arr[2 * per:3 * per], arr[3 * per:]]
            if any(len(p) == 0 for p in parts):
                plan.append(None)
                continue
            plan.append(len(streams))
            streams += parts
            owner += [bi] * 4
        encoded = self.encode_batch(streams, [tables[o] for o in owner])
        out: list[bytes | None] = []
        for base in plan:
            es = None if base is None else encoded[base:base + 4]
            if es is None or any(len(e) > 0xFFFF for e in es[:3]):
                out.append(None)
                continue
            out.append(b"".join(len(e).to_bytes(2, "little") for e in es[:3]) + b"".join(es))
        return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

#: one decode table row: ``sym | nbits << 8`` for every MAX_BITS-bit window
#: (a table of ``max_bits`` uses the first ``2^max_bits`` entries)
DTABLE = 1 << MAX_BITS
#: the columns of a decode batch's ``rows``
DECODE_COLS = ("byte_start", "n_bytes", "start_bit", "n_syms", "dst_off", "table", "max_bits")
#: the tensor arguments of :func:`decode_streams`, in order
DECODE_ARGS = ("payload", "rows", "tables")
#: the longest row the CUDA decoder stages in shared memory, in bytes; a
#: longer one reads its bits from global memory (``csrc/huffman_decode.cu``)
STAGE_CAP = 16 * 1024
#: rows of this many bytes or more are beyond the CUDA decoder's int32 bit
#: positions
MAX_ROW_BYTES = 1 << 26


def _check_decode(payload, rows, tables) -> None:
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("payload must be a flat uint8 tensor")
    if rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[1] != len(DECODE_COLS):
        raise ValueError(f"rows must be (S, {len(DECODE_COLS)}) int64 {DECODE_COLS}")
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[1] != DTABLE:
        raise ValueError(f"tables must be (T, {DTABLE}) int32 sym | nbits << 8")


def malformed(rows, payload_len: int, n_tables: int):
    """(S,) bool: the rows that decode nothing and get ``final = -1``: a
    table index outside ``[0, n_tables)``, ``max_bits`` outside 1..11,
    bytes outside the payload, or ``start_bit`` outside ``[0, 8 *
    n_bytes)``.  ``build_decode_batch`` makes none."""
    start, nbytes, p, _, _, tab, mb = rows.unbind(1)
    return ((tab < 0) | (tab >= n_tables) | (mb < 1) | (mb > MAX_BITS) | (start < 0)
            | (nbytes < 0) | (start + nbytes > payload_len) | (p < 0) | (p >= 8 * nbytes))


def decode_streams_plain(payload, rows, tables, *, n_out: int, widest: int | None = None):
    """Batched backward Huffman stream decode in plain PyTorch.

    payload: flat uint8, stream ``s`` in bytes ``[byte_start, + n_bytes)``;
    rows: (S, 7) int64 (``DECODE_COLS``): the sentinel's bit position
    ``start_bit``, the symbol count, the first output byte ``dst_off``, the
    table row and its ``max_bits``; tables: (T, 2048) int32 ``sym | nbits
    << 8``, of which the low 16 bits are read.  From ``p = start_bit``,
    each symbol is the table entry of the ``max_bits`` bits below ``p``
    (zero below bit 0), written to ``dst_off + k`` unless that lies outside
    ``[0, n_out)``; then ``p = max(p - nbits, 0)``, the clamp of
    ``huffman_jax.decode_streams_scan``.  Streams' destinations must not
    overlap.  A :func:`malformed` row writes nothing.  ``widest`` is the
    wrapper's stage size, unused here.

    Returns ``(out (n_out,) uint8, zero where no stream writes; final (S,)
    int32)``: ``final`` is the position before the last symbol minus its
    bit count, 0 for a fully consumed stream (and for ``n_syms = 0``), -1
    for a malformed row."""
    _check_decode(payload, rows, tables)
    dev = payload.device
    S = rows.shape[0]
    out = torch.zeros(n_out + 1, dtype=torch.uint8, device=dev)  # [n_out]: skipped writes
    final = torch.zeros(S, dtype=torch.int64, device=dev)
    if S == 0:
        return out[:n_out], final.to(torch.int32)
    bad = malformed(rows, payload.numel(), tables.shape[0])
    # a malformed row reads as a row of no byte and no symbol
    start, nbytes, p, n, dst, tab, mb = (torch.where(bad, 0, c) for c in rows.unbind(1))
    mb = torch.where(bad, 1, mb)
    # the table entry at every bit position of every stream, in one flat
    # bit space: stream s owns bits [bit0[s], bit0[s] + 8 * n_bytes[s]); a
    # zero entry closes it, for the rows of no byte
    nbits = nbytes * 8
    bit0 = torch.cumsum(nbits, 0) - nbits
    sid = torch.repeat_interleave(torch.arange(S, device=dev), nbits)
    q = torch.arange(sid.numel(), device=dev) - bit0[sid]
    lo = q - mb[sid]  # the window's lowest bit, may be negative
    byte = lo >> 3
    word = torch.zeros_like(lo)
    for j in range(3):  # a window of <= 11 bits spans at most three bytes
        b = byte + j
        ok = (b >= 0) & (b < nbytes[sid])
        v = payload[torch.where(ok, start[sid] + b, 0)].to(torch.int64)
        word |= torch.where(ok, v, 0) << (8 * j)
    win = (word >> (lo & 7)) & ((1 << mb[sid]) - 1)
    entry = torch.cat([(tables.to(torch.int64)[tab[sid], win] & 0xFFFF),
                       torch.zeros(1, dtype=torch.int64, device=dev)])

    for k in range(int(n.max())):
        e = entry[bit0 + p]
        nb = e >> 8
        d = dst + k
        act = (k < n) & (d >= 0) & (d < n_out)
        out[torch.where(act, d, n_out)] = (e & 0xFF).to(torch.uint8)
        final = torch.where(k == n - 1, p - nb, final)
        p = (p - nb).clamp(min=0)
    return out[:n_out], torch.where(bad, -1, final).to(torch.int32)


def stage_size(widest: int) -> int:
    """The bytes of a row the CUDA decoder stages in shared memory for a
    batch whose longest row is ``widest`` bytes; raises ValueError where
    that row's bit positions would not fit the kernel's int32."""
    if widest >= MAX_ROW_BYTES:
        raise ValueError(f"a row of {widest} bytes is beyond the kernel's int32 bit positions "
                         f"(2**26 bytes or more)")
    return min(max(widest, 0), STAGE_CAP)


def ctas_per_sm(widest: int) -> int:
    """How many CTAs of the CUDA decoder one SM of the current GPU holds at
    once for a batch whose longest row is ``widest`` bytes (a CTA a row)."""
    blocks = ctypes.c_int(0)
    _build.check(_build.lib().zp_huffman_decode_occupancy(stage_size(widest),
                                                          ctypes.byref(blocks)),
                 "huffman_decode occupancy")
    return blocks.value


def decode_streams(payload, rows, tables, *, n_out: int, widest: int | None = None):
    """:func:`decode_streams_plain` on the CPU; on a GPU, the CUDA decoder
    (``csrc/huffman_decode.cu``).  Same inputs, same outputs.

    ``widest``, the batch's largest ``n_bytes`` (``build_decode_batch``
    returns it), sizes the kernel's shared-memory stage without a read-back;
    without it the wrapper reads it from ``rows``, one device-to-host copy.
    A row above :data:`STAGE_CAP` bytes reads global memory; a batch whose
    ``widest`` is :data:`MAX_ROW_BYTES` or more raises ValueError before any
    launch."""
    args = (payload, rows, tables)
    if payload.device.type == "cpu":
        return decode_streams_plain(*args, n_out=n_out)
    if payload.device.type != "cuda":
        raise ValueError("decode_streams takes CPU or CUDA tensors")
    _check_decode(*args)
    for name, t in zip(DECODE_ARGS, args):
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {payload.device}")
    S = rows.shape[0]
    if widest is None:
        widest = int(rows[:, 1].max()) if S else 0
    stage = stage_size(widest)
    out = torch.zeros(n_out, dtype=torch.uint8, device=payload.device)
    final = torch.zeros(S, dtype=torch.int32, device=payload.device)
    if S == 0:
        return out, final
    lib = _build.lib()
    with torch.cuda.device(payload.device):
        rc = lib.zp_huffman_decode(
            payload.data_ptr(), payload.numel(), rows.data_ptr(), S, tables.data_ptr(),
            tables.shape[0], out.data_ptr(), n_out, final.data_ptr(), stage,
            torch.cuda.current_stream(payload.device).cuda_stream)
    _build.check(rc, "huffman_decode")
    LAUNCHES["huffman_decode"] += 1
    return out, final


def build_decode_batch(payloads: list[bytes], tables, n_symbols: list[int],
                       dst_off: list[int] | None = None) -> dict:
    """The flat batch of :func:`decode_streams` as numpy arrays (``payload``,
    ``rows``, ``tables``), plus ``n_out`` and ``widest`` (the longest
    payload's bytes).  ``tables[i]`` is stream i's ``HuffDecodeTable``;
    streams that share a table object share its row.  Streams decode back
    to back unless ``dst_off`` places them.  Raises DecompressError, as
    ``DeviceHuffmanDecoder`` does, for a stream with no sentinel bit."""
    for p in payloads:
        if not p or p[-1] == 0:
            raise DecompressError("huffman stream missing sentinel")
    n = np.asarray(n_symbols, dtype=np.int64)
    if dst_off is None:
        dst_off = np.cumsum(n) - n
    dst_off = np.asarray(dst_off, dtype=np.int64)
    unique: dict[int, int] = {}  # id(table) -> its row
    for t in tables:
        unique.setdefault(id(t), len(unique))
    tab_rows = np.zeros((len(unique), DTABLE), dtype=np.int32)
    tab_idx = np.array([unique[id(t)] for t in tables], dtype=np.int64)
    for t, k in zip(tables, tab_idx):
        tab_rows[k, : 1 << t.max_bits] = (t.symbols.astype(np.int32)
                                          | (t.nb_bits.astype(np.int32) << 8))
    nbytes = np.array([len(p) for p in payloads], dtype=np.int64)
    start_bit = np.array([(len(p) - 1) * 8 + p[-1].bit_length() - 1 for p in payloads],
                         dtype=np.int64)
    rows = np.stack([np.cumsum(nbytes) - nbytes, nbytes, start_bit, n, dst_off, tab_idx,
                     np.array([t.max_bits for t in tables], dtype=np.int64)],
                    axis=1).reshape(-1, len(DECODE_COLS))
    return {"payload": np.frombuffer(bytearray(b"".join(payloads)), dtype=np.uint8),
            "rows": rows, "tables": tab_rows, "n_out": int((dst_off + n).max(initial=0)),
            "widest": int(nbytes.max(initial=0))}


class TorchHuffmanDecoder:
    """Host wrapper: pack backward Huffman streams into one flat batch,
    decode it on ``device`` in one launch.  The device analog of
    ``huffman_jax.DeviceHuffmanDecoder``, bit-exact vs
    ``huffman._decode_one_stream``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def decode_batch_device(self, payloads: list[bytes], tables, n_symbols: list[int],
                            dst_off: list[int] | None = None, n_out: int | None = None):
        """Returns ``(syms, final)``: the decoded symbols as a flat uint8
        tensor on the device, stream i's at ``dst_off[i]`` (back to back
        without ``dst_off``), ``n_out`` bytes long (the end of the last
        stream without it), and ``final`` (S,) np.int32, which must be 0
        for every valid stream."""
        batch = build_decode_batch(payloads, tables, n_symbols, dst_off)
        syms, final = decode_streams(
            *(torch.from_numpy(batch[k]).to(self.device) for k in DECODE_ARGS),
            n_out=batch["n_out"] if n_out is None else n_out, widest=batch["widest"])
        return syms, final.cpu().numpy()

    def decode_batch(self, payloads: list[bytes], tables, n_symbols: list[int]) -> list[np.ndarray]:
        """payloads[i]: one backward-read huffman stream; tables[i]:
        HuffDecodeTable; n_symbols[i]: expected regenerated count.  Raises
        DecompressError for a stream that is not fully consumed."""
        if not payloads:
            return []
        syms, final = self.decode_batch_device(payloads, tables, n_symbols)
        if ((np.asarray(n_symbols) > 0) & (final != 0)).any():
            raise DecompressError("huffman stream not fully consumed")
        flat = syms.cpu().numpy()
        ends = np.cumsum(n_symbols)
        return [flat[e - k:e] for e, k in zip(ends.tolist(), n_symbols)]
