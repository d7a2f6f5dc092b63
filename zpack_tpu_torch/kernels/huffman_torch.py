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
batch is one flat uint8 symbol buffer, one row a stream (``ENCODE_COLS``:
its symbols ``[start, start + n)``, its table, its ``bits`` as the host
counted them, and ``word``, the first of the ``bits // 32 + 1`` words it
owns in one flat u32 plane), and one ``(256,)`` table a distinct table,
packed ``code | len << 12`` in 16 bits.  In stream ``s``, symbol ``i``
occupies bits ``[bits - incl_cumsum(len)[i], +len[i])`` of its little-endian
words, so symbol 0 sits highest, and the sentinel bit sits at ``bits``.
The planes are returned in an int32 tensor.

The decode contract is ``huffman._decode_one_stream``'s, layout in
:func:`decode_streams_plain`.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..errors import CompressError, DecompressError
from ..parallel.mesh import as_mesh, row_ranges
from ..utils.observe import launched, metrics

from . import _build

#: zstd huffman code-length limit (RFC 8878 §4.2.1)
MAX_BITS = 11
_M32 = 0xFFFFFFFF


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


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

#: the columns of an encode batch's ``rows``
ENCODE_COLS = ("start", "n", "table", "bits", "word")
#: the tensor arguments of :func:`encode_streams`, in order
BATCH_ARGS = ("syms", "rows", "tables")
#: a stream's bits must fit the kernel's int32 positions
MAX_STREAM_BITS = (1 << 31) - 64


def pack_tables(tables) -> np.ndarray:
    """``(T, 256)`` int16 rows holding ``code | len << 12`` as 16 bits, one a
    ``codecs.zstd.huffman.HuffEncodeTable`` (symbols past a table's end have
    length 0; each code cut to its length)."""
    out = np.zeros((len(tables), 256), dtype=np.int64)
    for key, shift in (("lengths", 12), ("codes", 0)):
        cols = [getattr(t, key) for t in tables]
        n = np.array([len(c) for c in cols], dtype=np.int64)
        if n.sum():
            first = np.arange(len(tables)) * 256 - (np.cumsum(n) - n)
            at = np.repeat(first, n) + np.arange(n.sum())
            vals = np.concatenate(cols).astype(np.int64)
            out.reshape(-1)[at] |= (vals << shift) if shift else vals & 0xFFF
    lens = out >> 12
    if (lens > MAX_BITS).any():
        raise CompressError(f"huffman code length above {MAX_BITS}")
    out = (lens << 12) | (out & ((1 << lens) - 1))
    return out.astype(np.uint16).view(np.int16)


def _check(syms, rows, tables) -> None:
    if syms.dtype != torch.uint8 or syms.dim() != 1:
        raise ValueError("syms must be a flat uint8 tensor")
    if rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[1] != len(ENCODE_COLS):
        raise ValueError(f"rows must be (S, {len(ENCODE_COLS)}) int64 {ENCODE_COLS}")
    if tables.dtype != torch.int16 or tables.dim() != 2 or tables.shape[1] != 256:
        raise ValueError("tables must be (T, 256) int16 code | len << 12")


def encode_streams_plain(syms, rows, tables, *, n_words: int):
    """Batched Huffman stream encode in plain PyTorch.

    syms: flat uint8; rows: (S, 5) int64 (``ENCODE_COLS``); tables: (T,
    256) int16 ``code | len << 12``.  Stream ``s`` owns words ``[word,
    word + bits // 32 + 1)`` of the plane; the ranges must not overlap.
    Returns ``(words (n_words,) int32,
    total_bits (S,) int32)``: ``total_bits`` is each stream's sum of code
    lengths, which must equal ``bits`` (where it does not, the words are
    undefined, and here the call may raise); words no stream owns are zero here (the CUDA kernel leaves
    them unwritten, and :func:`build_batch` makes none)."""
    _check(syms, rows, tables)
    dev = syms.device
    S = rows.shape[0]
    start, n, tab, bits, word = rows.unbind(1)
    sid = torch.repeat_interleave(torch.arange(S, device=dev), n)
    local = torch.arange(sid.numel(), device=dev) - (torch.cumsum(n, 0) - n)[sid]
    entry = tables.to(torch.int64)[tab[sid], syms[start[sid] + local].to(torch.int64)] & 0xFFFF
    lens = entry >> 12
    codes = entry & 0xFFF & ((1 << lens) - 1)
    total = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(0, sid, lens)
    incl = torch.cumsum(lens, 0) - (torch.cumsum(total, 0) - total)[sid]
    base = word * 32 + bits
    pos = torch.cat([base[sid] - incl, base])
    vals = torch.cat([codes, torch.ones_like(total)])  # codes, then sentinels
    return scatter_bits(n_words, pos, vals), total.to(torch.int32)


def _encode_launch(args, words, total) -> None:
    """One launch of ``csrc/huffman_encode.cu`` on checked tensors, writing
    ``words`` and ``total`` (made by the caller: the launch alone, for
    timing)."""
    syms, rows, tables = args
    lib = _build.lib()
    with torch.cuda.device(syms.device):
        rc = lib.zp_huffman_encode(
            syms.data_ptr(), rows.data_ptr(), tables.data_ptr(), rows.shape[0],
            words.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(syms.device).cuda_stream)
    _build.check(rc, "huffman_encode")


def encode_streams(syms, rows, tables, *, n_words: int):
    """:func:`encode_streams_plain` on the CPU; on a GPU, the CUDA encoder
    (``csrc/huffman_encode.cu``, a CTA a stream).  Same inputs, same outputs
    where every word of the plane belongs to a stream, as in a batch of
    :func:`build_batch` (the kernel writes no other word, and allocates the
    plane with ``torch.empty``).  ``syms`` and ``tables`` must start on 16
    bytes, and no stream's ``bits`` reach :data:`MAX_STREAM_BITS`."""
    args = (syms, rows, tables)
    if syms.device.type == "cpu":
        return encode_streams_plain(*args, n_words=n_words)
    if syms.device.type != "cuda":
        raise ValueError("encode_streams takes CPU or CUDA tensors")
    _check(*args)
    for name, t in zip(BATCH_ARGS, args):
        if t.device != syms.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {syms.device}")
    if syms.data_ptr() % 16 or tables.data_ptr() % 16:
        raise ValueError("syms and tables must start on 16 bytes")
    words = torch.empty(n_words, dtype=torch.int32, device=syms.device)
    total = torch.empty(rows.shape[0], dtype=torch.int32, device=syms.device)
    if rows.shape[0]:
        _encode_launch(args, words, total)
        launched("huffman_encode")
    return words, total


def _batch(syms: np.ndarray, counts: np.ndarray, tab_idx: np.ndarray, tabs: np.ndarray) -> dict:
    """The batch of rows ``counts`` back to back in ``syms``, row ``s`` coded
    by ``tabs[tab_idx[s]]``: each row's bits counted from one histogram of
    the whole batch, the rows' words back to back."""
    S = len(counts)
    lens = (tabs.view(np.uint16) >> 12).astype(np.int64)[tab_idx]  # (S, 256)
    hist = np.bincount(np.repeat(np.arange(S, dtype=np.int64) * 256, counts) + syms,
                       minlength=S * 256).reshape(S, 256)
    if (hist[lens == 0] > 0).any():
        raise CompressError("huffman table misses a packed symbol")
    bits = (hist * lens).sum(1)
    if (bits >= MAX_STREAM_BITS).any():
        raise ValueError("a stream's bits are beyond the kernel's int32 bit positions")
    size = bits // 32 + 1
    rows = np.stack([np.cumsum(counts) - counts, counts, tab_idx, bits, np.cumsum(size) - size],
                    axis=1)
    return {"syms": syms, "rows": rows.astype(np.int64).reshape(S, len(ENCODE_COLS)),
            "tables": tabs, "n_words": int(size.sum())}


def _distinct(tables) -> tuple[np.ndarray, list]:
    """Each table's index among the distinct table objects, and those."""
    rows: dict[int, int] = {}
    distinct = []
    for t in tables:
        if id(t) not in rows:
            rows[id(t)] = len(distinct)
            distinct.append(t)
    return np.array([rows[id(t)] for t in tables], dtype=np.int64), distinct


def build_batch(streams: list[np.ndarray], tables) -> dict:
    """The flat batch of :func:`encode_streams` as numpy arrays (``syms``,
    ``rows``, ``tables``) plus ``n_words``: stream ``i`` coded by
    ``tables[i]`` (a ``HuffEncodeTable``; streams that share a table object
    share its row).  Raises CompressError, as ``huffman._encode_stream``
    does, when a stream holds a symbol its table has no code for."""
    streams = [np.asarray(s, dtype=np.uint8) for s in streams]
    idx, distinct = _distinct(tables)
    syms = np.concatenate(streams) if streams else np.zeros(0, np.uint8)
    return _batch(syms, np.array([len(s) for s in streams], dtype=np.int64), idx,
                  pack_tables(distinct))


def build_4stream_batch(lit_blocks: list[np.ndarray], tables) -> tuple[dict, np.ndarray]:
    """The batch of ``huffman.encode_4stream`` over many blocks: each block's
    literals split into four streams of ``ceil(n / 4)`` symbols, the last
    the rest, coded by the block's table.  Returns the batch and which
    blocks are in it (those whose four parts are not empty)."""
    blocks = [np.asarray(b, dtype=np.uint8) for b in lit_blocks]
    n = np.array([len(b) for b in blocks], dtype=np.int64)
    per = (n + 3) // 4
    ok = (per > 0) & (n - 3 * per > 0)
    idx, distinct = _distinct([t for t, k in zip(tables, ok) if k])
    kept = np.flatnonzero(ok)
    syms = (np.concatenate([blocks[i] for i in kept]) if kept.size
            else np.zeros(0, np.uint8))
    counts = np.stack([per[kept]] * 3 + [n[kept] - 3 * per[kept]], axis=1).reshape(-1)
    return _batch(syms, counts, np.repeat(idx, 4), pack_tables(distinct)), ok


class TorchHuffmanEncoder:
    """Host wrapper: pack literal streams into one flat batch, encode it on
    ``device`` in one launch, cut the payloads (each identical to
    ``huffman._encode_stream``).  The device analog of
    ``huffman_jax.DeviceHuffmanEncoder``; ``encode_literal_sections``
    takes either.

    ``device`` may be a ``DeviceMesh`` (the JAX ``shard_rows``): the
    batch's rows split into contiguous ranges, one a mesh device, each
    range encoded in one launch on its device with the whole table array,
    and the words of the ranges, back to back in row order, make the
    batch's plane."""

    def __init__(self, device):
        self.mesh = as_mesh(device)
        self.device = self.mesh.devices[0]

    def _payloads(self, batch: dict) -> tuple[bytes, list, list]:
        """Encode ``batch``; returns the plane's bytes, and each row's first
        byte in them and its payload's bytes."""
        rows = batch["rows"]
        tables = {d: torch.from_numpy(batch["tables"]).to(d) for d in self.mesh.distinct()}
        launched = []
        for (lo, hi), dev in zip(row_ranges(len(rows), self.mesh.size), self.mesh.devices):
            if lo == hi:
                continue
            part = rows[lo:hi].copy()
            s0, w0 = part[0, 0], part[0, 4]
            s1, w1 = part[-1, 0] + part[-1, 1], part[-1, 4] + part[-1, 3] // 32 + 1
            part[:, 0] -= s0
            part[:, 4] -= w0
            launched.append(encode_streams(
                torch.from_numpy(batch["syms"][s0:s1]).to(dev), torch.from_numpy(part).to(dev),
                tables[dev], n_words=int(w1 - w0)))
        total = np.concatenate([t.cpu().numpy() for _, t in launched])
        if not np.array_equal(total, rows[:, 3]):
            raise RuntimeError("huffman_encode: total_bits disagree with the host's count")
        return (b"".join(w.cpu().numpy().tobytes() for w, _ in launched),
                (4 * rows[:, 4]).tolist(), ((rows[:, 3] + 8) // 8).tolist())

    def encode_batch(self, streams: list[np.ndarray], tables) -> list[bytes]:
        """streams[i]: uint8 symbol array; tables[i]: HuffEncodeTable for
        stream i.  Returns the encoded byte payload of each stream."""
        if not streams:
            return []
        data, at, nbytes = self._payloads(build_batch(streams, tables))
        return [data[a:a + k] for a, k in zip(at, nbytes)]

    def encode_4stream_batch(self, lit_blocks: list[np.ndarray], tables) -> list[bytes | None]:
        """Device analog of ``huffman.encode_4stream`` for a batch of blocks:
        each block's literals split into 4 sub-streams, all encoded in one
        launch; jump table and concatenation on the host.  ``None`` where a
        part is empty or one of the first three exceeds 0xFFFF bytes."""
        batch, ok = build_4stream_batch(lit_blocks, tables)
        out: list[bytes | None] = [None] * len(lit_blocks)
        if not ok.any():
            return out
        data, at, nbytes = self._payloads(batch)
        for j, b in enumerate(np.flatnonzero(ok).tolist()):
            k = nbytes[4 * j:4 * j + 4]
            if max(k[:3]) <= 0xFFFF:
                a = at[4 * j:4 * j + 4]
                out[b] = b"".join([struct.pack("<3H", *k[:3])]
                                  + [data[x:x + n] for x, n in zip(a, k)])
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
    launched("huffman_decode")
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
    ``huffman._decode_one_stream``.

    ``device`` may be a ``DeviceMesh``: the rows split into contiguous
    ranges, one a mesh device, each decoded in one launch on its device
    with the whole table array, its streams written back to back into a
    buffer of its own; the first mesh device gathers every shard's symbols
    into the output, each stream at its ``dst_off``, so no shard writes
    another's destinations."""

    def __init__(self, device):
        self.mesh = as_mesh(device)
        self.device = self.mesh.devices[0]

    def decode_batch_device(self, payloads: list[bytes], tables, n_symbols: list[int],
                            dst_off: list[int] | None = None, n_out: int | None = None):
        """Returns ``(syms, final)``: the decoded symbols as a flat uint8
        tensor on the device, stream i's at ``dst_off[i]`` (back to back
        without ``dst_off``), ``n_out`` bytes long (the end of the last
        stream without it), and ``final`` (S,) np.int32, which must be 0
        for every valid stream."""
        batch = build_decode_batch(payloads, tables, n_symbols, dst_off)
        return self.decode_built(batch, batch["n_out"] if n_out is None else n_out)

    def decode_built(self, batch: dict, n_out: int):
        """:meth:`decode_batch_device` on a batch of
        :func:`build_decode_batch` (its rows as they stand, malformed ones
        included), or one made alike: its ``payload`` may be a uint8 tensor,
        on the device or not, such as the whole entry the rows point into."""
        if self.mesh.size == 1:
            with metrics.phase("torch.huffman_decode.wait"):  # blocking uploads
                args = [torch.as_tensor(batch[k]).to(self.device) for k in DECODE_ARGS]
            syms, final = decode_streams(*args, n_out=n_out, widest=batch["widest"])
            with metrics.phase("torch.huffman_decode.wait", final.nbytes):
                return syms, final.cpu().numpy()
        rows, payload = batch["rows"], batch["payload"]
        bad = malformed(torch.from_numpy(rows), len(payload), len(batch["tables"])).numpy()
        # a shard's rows: bytes rebased to its part of the payload, symbols
        # back to back from 0; a malformed row keeps its verdict (an
        # invalid table) and writes nothing
        n = np.where(bad, 0, np.maximum(rows[:, 3], 0))
        with metrics.phase("torch.huffman_decode.wait"):  # blocking uploads
            tables = {d: torch.from_numpy(batch["tables"]).to(d) for d in self.mesh.distinct()}
        launched = []
        for (lo, hi), dev in zip(row_ranges(len(rows), self.mesh.size), self.mesh.devices):
            if lo == hi:
                continue
            part, ok = rows[lo:hi].copy(), ~bad[lo:hi]
            p0 = int(part[ok, 0].min()) if ok.any() else 0
            p1 = int((part[ok, 0] + part[ok, 1]).max()) if ok.any() else 0
            part[:, 0] -= p0
            part[:, 3] = n[lo:hi]
            part[:, 4] = np.cumsum(n[lo:hi]) - n[lo:hi]
            part[~ok, 5] = -1
            with metrics.phase("torch.huffman_decode.wait"):  # blocking uploads
                args = torch.as_tensor(payload[p0:p1]).to(dev), torch.from_numpy(part).to(dev)
            out, final = decode_streams(*args, tables[dev], n_out=int(n[lo:hi].sum()),
                                        widest=int(part[ok, 1].max(initial=0)))
            launched.append((lo, hi, out, final))
        dev0 = self.device
        syms = torch.zeros(n_out, dtype=torch.uint8, device=dev0)
        for lo, hi, out, _ in launched:
            # each symbol's place in the output; those outside it are skipped
            # as the single-device decode skips them
            k = n[lo:hi]
            shift = torch.from_numpy(rows[lo:hi, 4] - (np.cumsum(k) - k)).to(dev0)
            dst = torch.repeat_interleave(shift, torch.from_numpy(k).to(dev0),
                                          output_size=out.numel()) \
                + torch.arange(out.numel(), device=dev0)
            keep = (dst >= 0) & (dst < n_out)
            syms[dst[keep]] = out.to(dev0)[keep]
        with metrics.phase("torch.huffman_decode.wait", sum(f.nbytes for *_, f in launched)):
            return syms, np.concatenate([f.cpu().numpy() for _, _, _, f in launched])

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
