"""zstd FSE sequence sections for PyTorch: encode, decode, repeat offsets.

Counterpart of ``zpack_tpu/kernels/fse_jax.py``.  The encode half
(``encode_seq_streams`` with ``_init_state``, and
``DeviceSequenceEncoder``) is described here; the decode half
(``decode_seq_streams``, ``DeviceSequenceDecoder``) and the repeat-offset
resolution (``rep_prefix_maps``, ``apply_rep_maps``) follow the same
pattern, each contract stated by its plain version below.  The encoder has
two halves:

* a plain PyTorch version (``encode_seq_streams_plain``) that states the
  contract and runs on any device: a Python loop over the steps of the
  state chains, vectorized over blocks, like the JAX ``lax.scan``;
* a wrapper (``encode_seq_streams``) that takes the plain version for a
  tensor on the CPU and launches the hand-written CUDA kernel
  (``csrc/fse_encode.cu``) for a tensor on a GPU.  It never falls back: a
  build or launch error raises.

The contract is ``codecs/zstd/seq.encode_sequences`` followed by
``BackwardBitWriter.finish()``, per block: initialize the LL, OF and ML
states on the last sequence and write its extra bits (ll, ml, of); then for
each earlier sequence, last to first, the state bits (of, ml, ll) and the
extra bits (ll, ml, of); then flush ml, of, ll at their accuracy logs;
fields packed LSB-first, then the sentinel bit.

A batch is flat.  ``fields`` (total, 4) int32 holds every block's sequences
in reversed order (block ``b`` owns rows ``[seq_off[b], seq_off[b + 1])``):
``llc | mlc << 8 | ofc << 16``, then the ll, ml and of extra values; the
extra-bit counts follow from the codes (``LL_BITS``, ``ML_BITS``, ``ofc``).
``tables`` (B, 3, 640) int32 holds the ll, of and ml encode tables, each
``state_table[512] | delta_nb_bits[64] | delta_find_state[64]``, and
``al`` (B, 3) their accuracy logs (0, with all-zero rows, for RLE mode).
Block ``b`` owns words ``[word_off[b], word_off[b + 1])`` of the output.

The host pre-pass copies ``fse_jax``'s numpy helpers (``_bit_length``,
``ll_codes_np``, ``ml_codes_np``, ``of_codes_np``): that module imports jax
at the top.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..codecs.zstd import seq as zseq
from ..errors import DecompressError
from ..parallel.mesh import as_mesh, row_ranges
from ..utils.observe import launched, metrics

from . import _build
from .huffman_torch import scatter_bits

#: max symbols of any sequence-code alphabet (ML has 53) padded to a lane
NSYM = 64
#: max FSE table size: 1 << max(LL_MAX_AL, ML_MAX_AL, OF_MAX_AL) = 1 << 9
TABLE = 512
#: one packed table row: state table, delta_nb_bits, delta_find_state
ROW = TABLE + 2 * NSYM


# dense numpy versions of seq.ll_code / seq.ml_code (copies of fse_jax's) ----

_LL_SMALL_NP = np.array(zseq._LL_SMALL, dtype=np.int32)
_ML_SMALL_NP = np.array(zseq._ML_SMALL, dtype=np.int32)
_LL_BASE_NP = np.array(zseq.LL_BASELINES, dtype=np.int32)
_LL_BITS_NP = np.array(zseq.LL_BITS, dtype=np.int32)
_ML_BASE_NP = np.array(zseq.ML_BASELINES, dtype=np.int32)
_ML_BITS_NP = np.array(zseq.ML_BITS, dtype=np.int32)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Exact bit_length for int64 values < 2**53 (frexp is exact there)."""
    m = np.asarray(v, dtype=np.float64)
    return np.where(v > 0, np.frexp(m)[1], 0).astype(np.int32)


def ll_codes_np(lls: np.ndarray) -> np.ndarray:
    lls = np.asarray(lls, dtype=np.int64)
    big = 19 + _bit_length(np.maximum(lls, 1)) - 1
    small = _LL_SMALL_NP[np.minimum(lls, 63)]
    return np.where(lls > 63, big, small).astype(np.int32)


def ml_codes_np(mls: np.ndarray) -> np.ndarray:
    m = np.asarray(mls, dtype=np.int64) - 3
    big = 36 + _bit_length(np.maximum(m, 1)) - 1
    small = _ML_SMALL_NP[np.minimum(m, 127)]
    return np.where(m > 127, big, small).astype(np.int32)


def of_codes_np(ovs: np.ndarray) -> np.ndarray:
    return (_bit_length(np.asarray(ovs, dtype=np.int64)) - 1).astype(np.int32)


def _table_rows(t):
    """(state_table, delta_nb, delta_fs, al) int32 rows for one EncodeTable
    or _RleEncodeTable (a 0-bit machine).  Copy of
    ``DeviceSequenceEncoder._table_rows``."""
    st = np.zeros(TABLE, dtype=np.int32)
    dnb = np.zeros(NSYM, dtype=np.int32)
    dfs = np.zeros(NSYM, dtype=np.int32)
    al = getattr(t, "al", 0)
    if al:
        stt = np.asarray(t.state_table, dtype=np.int32)
        st[: len(stt)] = stt
        d1 = np.asarray(t.delta_nb_bits, dtype=np.int64)
        d2 = np.asarray(t.delta_find_state, dtype=np.int64)
        dnb[: len(d1)] = d1.astype(np.int32)
        dfs[: len(d2)] = d2.astype(np.int32)
    return st, dnb, dfs, al


def _check(fields, seq_off, tables, al, word_off) -> None:
    B = seq_off.shape[0] - 1
    if fields.dtype != torch.int32 or fields.dim() != 2 or fields.shape[1] != 4:
        raise ValueError("fields must be (total, 4) int32")
    if seq_off.dtype != torch.int64 or seq_off.dim() != 1 or B < 0:
        raise ValueError("seq_off must be (B + 1,) int64")
    if tables.dtype != torch.int32 or tables.shape != (B, 3, ROW):
        raise ValueError(f"tables must be (B, 3, {ROW}) int32")
    if al.dtype != torch.int32 or al.shape != (B, 3):
        raise ValueError("al must be (B, 3) int32")
    if word_off.dtype != torch.int64 or word_off.shape != (B + 1,):
        raise ValueError("word_off must be (B + 1,) int64")


def encode_seq_streams_plain(fields, seq_off, tables, al, word_off, *, n_words: int):
    """Batched sequence-bitstream encode in plain PyTorch (layout in the
    module docstring).  Returns ``(words (n_words,) int32, total_bits (B,)
    int32)``, each block's ``total_bits`` excluding its sentinel; words no
    block reaches stay zero."""
    _check(fields, seq_off, tables, al, word_off)
    dev = fields.device
    i64 = torch.int64
    B = seq_off.shape[0] - 1
    n = seq_off[1:] - seq_off[:-1]
    N = int(n.max()) if B else 0
    if N == 0:
        return torch.zeros(n_words, dtype=torch.int32, device=dev), n.to(torch.int32)
    k = torch.arange(N, device=dev)
    valid = k < n[:, None]  # (B, N)
    f = fields.to(i64)[torch.where(valid, seq_off[:-1, None] + k, 0)]  # (B, N, 4)
    llc = f[..., 0] & 0xFF
    mlc = (f[..., 0] >> 8) & 0xFF
    ofc = (f[..., 0] >> 16) & 0xFF
    tab = tables.to(i64)
    st, dnb, dfs = tab[..., :TABLE], tab[..., TABLE:TABLE + NSYM], tab[..., TABLE + NSYM:]
    code3 = torch.stack([llc, ofc, mlc], dim=1)  # (B, 3, N), the tables' order
    d = dnb.gather(2, code3)
    fs = dfs.gather(2, code3)

    # states init on the LAST sequence (k = 0): fse.EncodeTable.init_state
    nb0 = (d[..., 0] + (1 << 15)) >> 16
    val = (nb0 << 16) - d[..., 0]
    state = st.gather(2, ((val >> nb0) + fs[..., 0])[..., None])[..., 0]  # (B, 3)
    sv = torch.zeros((B, 3, N), dtype=i64, device=dev)  # state bits written at step k
    sn = torch.zeros((B, 3, N), dtype=i64, device=dev)
    for j in range(1, N):
        act = (j < n)[:, None]
        nb = torch.where(act, (state + d[..., j]) >> 16, 0)
        sv[..., j] = state & ((1 << nb) - 1)
        sn[..., j] = nb
        # inactive lanes read a clamped junk entry and keep their state
        nxt = st.gather(2, ((state >> nb) + fs[..., j]).clamp(0, TABLE - 1)[..., None])[..., 0]
        state = torch.where(act, nxt, state)

    # items in emission order per step: of, ml, ll state bits (none at
    # k = 0), then ll, ml, of extra bits; then the flush of ml, of, ll
    xv = f[..., 1:] & 0xFFFFFFFF
    xn = torch.stack([torch.from_numpy(_LL_BITS_NP).to(dev)[llc].to(i64),
                      torch.from_numpy(_ML_BITS_NP).to(dev)[mlc].to(i64), ofc], dim=2)
    xn = torch.where(valid[..., None], xn, 0)
    order = [1, 2, 0]  # (ll, of, ml) -> of, ml, ll
    vals = torch.cat([sv[:, order].transpose(1, 2), xv & ((1 << xn) - 1)], dim=2).reshape(B, -1)
    nbs = torch.cat([sn[:, order].transpose(1, 2), xn], dim=2).reshape(B, -1)
    flush = [2, 1, 0]  # ml, of, ll
    al64 = al.to(i64)[:, flush]
    vals = torch.cat([vals, state[:, flush] & ((1 << al64) - 1)], dim=1)
    nbs = torch.cat([nbs, al64], dim=1)
    csum = torch.cumsum(nbs, dim=1)
    total = csum[:, -1]
    base = word_off[:-1, None] * 32
    pos = torch.cat([(base + csum - nbs).reshape(-1), base[:, 0] + total])
    vals = torch.cat([vals.reshape(-1), torch.ones_like(total)])  # fields, then sentinels
    return scatter_bits(n_words, pos, vals), total.to(torch.int32)


#: the most sequences of one block the CUDA encoder stages in shared memory
#: (10 bytes each: the code word and three 16-bit states, so 80 KiB); a
#: longer block works in a global scratch.  Read at each launch, so a test
#: can lower it.
ENCODE_STAGE_CAP = 8192


def encode_seq_streams(fields, seq_off, tables, al, word_off, *, n_words: int):
    """:func:`encode_seq_streams_plain` on the CPU; on a GPU, the CUDA
    encoder (``csrc/fse_encode.cu``).  Same inputs, same outputs."""
    args = (fields, seq_off, tables, al, word_off)
    if fields.device.type == "cpu":
        return encode_seq_streams_plain(*args, n_words=n_words)
    if fields.device.type != "cuda":
        raise ValueError("encode_seq_streams takes CPU or CUDA tensors")
    _check(*args)
    for name, t in zip(("fields", "seq_off", "tables", "al", "word_off"), args):
        if t.device != fields.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {fields.device}")
    if fields.data_ptr() % 16:
        raise ValueError("fields must start on a 16-byte boundary (rows load as int4)")
    B = seq_off.shape[0] - 1
    words = torch.zeros(n_words, dtype=torch.int32, device=fields.device)
    total = torch.empty(B, dtype=torch.int32, device=fields.device)
    if B == 0:
        return words, total
    _encode_launch(args, words, total, 3)
    launched("fse_encode")
    return words, total


def encode_stage(total: int) -> int:
    """The sequences a block may stage in shared memory in a launch of
    ``total`` sequences: all of them, up to :data:`ENCODE_STAGE_CAP`."""
    return min(total, ENCODE_STAGE_CAP)


def encode_ctas_per_sm(stage: int) -> int:
    """How many CTAs of the CUDA encoder (a CTA a block) one SM of the
    current GPU holds at once with a stage of ``stage`` sequences."""
    blocks = ctypes.c_int(0)
    _build.check(_build.lib().zp_fse_encode_occupancy(stage, ctypes.byref(blocks)),
                 "fse_encode occupancy")
    return blocks.value


def _encode_launch(args, words, total, steps: int) -> None:
    """One launch of ``csrc/fse_encode.cu`` on checked tensors.  ``steps`` 3
    encodes; 1 runs the state walk alone and 2 the packing alone, for timing
    only (their outputs mean nothing).  The stage holds the batch's
    sequences up to :data:`ENCODE_STAGE_CAP` (:func:`encode_stage`: the host
    knows it without a read-back); a block longer than the stage works in a
    scratch of 10 bytes a sequence."""
    fields, seq_off, tables, al, word_off = args
    n = fields.shape[0]
    stage = encode_stage(n)
    scratch = torch.empty(-(-10 * n // 4) if n > stage else 1, dtype=torch.int32,
                          device=fields.device)
    lib = _build.lib()
    with torch.cuda.device(fields.device):
        rc = lib.zp_fse_encode(
            fields.data_ptr(), seq_off.data_ptr(), tables.data_ptr(), al.data_ptr(),
            word_off.data_ptr(), seq_off.shape[0] - 1, stage, steps, scratch.data_ptr(),
            words.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(fields.device).cuda_stream)
    _build.check(rc, "fse_encode")


def build_batch(blocks: list[tuple], tables: list[tuple]) -> dict:
    """The flat batch of :func:`encode_seq_streams` as numpy arrays
    (``fields``, ``seq_off``, ``tables``, ``al``, ``word_off``), plus
    ``n_words`` and each block's ``ub_bits``: the bound of
    ``encode.sequence_section_header`` (every state write at its accuracy
    log, plus every extra bit, the flush and the sentinel), which sizes the
    block's words."""
    ns = np.array([len(b[0]) for b in blocks], dtype=np.int64)
    if (ns == 0).any():
        raise ValueError("every block needs at least one sequence")
    rev = [np.asarray(b[c], dtype=np.int64)[::-1] for c in range(3) for b in blocks]
    nbk = len(blocks)
    lls, mls, ovs = (np.concatenate(rev[c * nbk:(c + 1) * nbk]) for c in range(3))
    llc, mlc, ofc = ll_codes_np(lls), ml_codes_np(mls), of_codes_np(ovs)
    fields = np.empty((len(lls), 4), dtype=np.int64)
    fields[:, 0] = llc | (mlc << 8) | (ofc << 16)
    fields[:, 1] = lls - _LL_BASE_NP[llc]
    fields[:, 2] = mls - _ML_BASE_NP[mlc]
    fields[:, 3] = ovs - (np.int64(1) << ofc.astype(np.int64))
    tabs = np.zeros((nbk, 3, ROW), dtype=np.int32)
    al = np.zeros((nbk, 3), dtype=np.int32)
    for i, kinds in enumerate(tables):
        for c, t in enumerate(kinds):  # (ll, of, ml)
            st, dnb, dfs, a = _table_rows(t)
            tabs[i, c] = np.concatenate([st, dnb, dfs])
            al[i, c] = a
    seq_off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    extra = np.concatenate([[0], np.cumsum(_LL_BITS_NP[llc] + _ML_BITS_NP[mlc] + ofc)])
    ub_bits = extra[seq_off[1:]] - extra[seq_off[:-1]] + (ns + 1) * al.sum(axis=1) + 1
    word_off = np.concatenate([[0], np.cumsum(ub_bits // 32 + 1)]).astype(np.int64)
    return {"fields": fields.astype(np.int32), "seq_off": seq_off, "tables": tabs, "al": al,
            "word_off": word_off, "n_words": int(word_off[-1]), "ub_bits": ub_bits}


#: the tensor arguments of :func:`encode_seq_streams`, in order
BATCH_ARGS = ("fields", "seq_off", "tables", "al", "word_off")


class TorchSequenceEncoder:
    """Host wrapper: pack per-block sequences and their chosen FSE encode
    tables into one flat batch, encode it on ``device`` in one launch, cut
    the byte payloads (each identical to ``seq.encode_sequences``).  The
    device analog of ``fse_jax.DeviceSequenceEncoder``.

    ``device`` may be a ``DeviceMesh``: the blocks split into contiguous
    ranges, one a mesh device, each encoded in one launch on its device
    with the whole table rows (its range a view of them), and the words of
    the ranges, back to back in block order, make the batch's plane."""

    def __init__(self, device):
        self.mesh = as_mesh(device)
        self.device = self.mesh.devices[0]

    def encode_batch(self, blocks: list[tuple], tables: list[tuple]) -> list[bytes]:
        """blocks[i] = (lls, mls, ovs) int arrays (non-empty); tables[i] =
        (ll_table, of_table, ml_table) from ``_pick_table``.  Returns each
        block's sequences bitstream."""
        if not blocks:
            return []
        batch = build_batch(blocks, tables)
        seq_off, word_off = batch["seq_off"], batch["word_off"]
        tabs = {d: torch.from_numpy(batch["tables"]).to(d) for d in self.mesh.distinct()}
        launched = []
        for (lo, hi), dev in zip(row_ranges(len(blocks), self.mesh.size), self.mesh.devices):
            if lo == hi:
                continue
            launched.append(encode_seq_streams(
                torch.from_numpy(batch["fields"][seq_off[lo]:seq_off[hi]]).to(dev),
                torch.from_numpy(seq_off[lo:hi + 1] - seq_off[lo]).to(dev), tabs[dev][lo:hi],
                torch.from_numpy(batch["al"][lo:hi]).to(dev),
                torch.from_numpy(word_off[lo:hi + 1] - word_off[lo]).to(dev),
                n_words=int(word_off[hi] - word_off[lo])))
        total = np.concatenate([t.cpu().numpy() for _, t in launched])
        plane = b"".join(w.cpu().numpy().tobytes() for w, _ in launched)
        return [plane[4 * int(word_off[i]): 4 * int(word_off[i]) + (int(total[i]) + 8) // 8]
                for i in range(len(blocks))]


# ---------------------------------------------------------------------------
# Decode (counterpart of fse_jax.py:362-480 and DeviceSequenceDecoder)
# ---------------------------------------------------------------------------

#: baseline | extra-bit count << 20 per literal-length and match-length code
#: (copies of fse_jax's ``_LL_CONST_NP`` / ``_ML_CONST_NP``)
_LL_CONST_NP = (_LL_BASE_NP | (_LL_BITS_NP << 20)).astype(np.int32)  # (36,)
_ML_CONST_NP = (_ML_BASE_NP | (_ML_BITS_NP << 20)).astype(np.int32)  # (53,)
#: the columns of a decode batch's ``rows``
DECODE_COLS = ("byte_start", "n_bytes", "bits_left0")
#: the tensor arguments of :func:`decode_seq_streams`, in order
DECODE_ARGS = ("payload", "rows", "seq_off", "al", "tables")
#: the longest row (bytes of bitstream) the CUDA decoder stages in shared
#: memory, a zstd block's bound; a longer one is read from global memory
STAGE_CAP = 128 << 10


def pack_decode_table(t, max_bits_pad: int = TABLE) -> np.ndarray:
    """Pack an fse.DecodeTable into (TABLE,) int32 rows:
    sym | nb_bits << 6 | new_state << 16 (sym<=52, nb<=9, ns<512).  Copy of
    ``fse_jax.pack_decode_table``."""
    out = np.zeros(max_bits_pad, np.int32)
    size = 1 << t.al
    out[:size] = (t.symbols.astype(np.int32)
                  | (t.nb_bits.astype(np.int32) << 6)
                  | (t.new_state.astype(np.int32) << 16))
    return out


def parse_headers(payload: bytes, pos: int, tables) -> tuple:
    """Parse one block's sequence-section headers (count, modes, table
    descriptors — the few-byte host part), mutating ``tables`` like the
    host decoder.  Returns (nb_seq, bitstream bytes).  Copy of
    ``fse_jax.DeviceSequenceDecoder.parse_headers``."""
    nb_seq, pos = zseq.parse_nb_sequences(payload, pos)
    if nb_seq == 0:
        return 0, b""
    if pos >= len(payload):
        raise DecompressError("missing compression modes byte")
    modes = payload[pos]
    pos += 1
    if modes & 0x3:
        raise DecompressError("reserved compression-mode bits set")
    tables.ll, pos = zseq._read_table(payload, pos, (modes >> 6) & 3, "ll",
                                      zseq.LL_CODE_MAX, zseq.LL_MAX_AL, tables.ll)
    tables.of, pos = zseq._read_table(payload, pos, (modes >> 4) & 3, "of",
                                      zseq.OF_CODE_MAX, zseq.OF_MAX_AL, tables.of)
    tables.ml, pos = zseq._read_table(payload, pos, (modes >> 2) & 3, "ml",
                                      zseq.ML_CODE_MAX, zseq.ML_MAX_AL, tables.ml)
    return nb_seq, payload[pos:]


def _check_decode(payload, rows, seq_off, al, tables) -> None:
    B = rows.shape[0]
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("payload must be a flat uint8 tensor")
    if rows.dtype != torch.int64 or rows.shape != (B, len(DECODE_COLS)):
        raise ValueError(f"rows must be (B, {len(DECODE_COLS)}) int64 {DECODE_COLS}")
    if seq_off.dtype != torch.int64 or seq_off.shape != (B + 1,):
        raise ValueError("seq_off must be (B + 1,) int64")
    if al.dtype != torch.int32 or al.shape != (B, 3):
        raise ValueError("al must be (B, 3) int32")
    if tables.dtype != torch.int32 or tables.shape != (B, 3, TABLE):
        raise ValueError(f"tables must be (B, 3, {TABLE}) int32")


def decode_seq_streams_plain(payload, rows, seq_off, al, tables, *, shape=None):
    """Batched sequence-section bitstream decode in plain PyTorch: a Python
    loop over the steps, vectorized over blocks, like the ``lax.scan`` of
    ``fse_jax.decode_seq_streams``.

    payload: flat uint8, block ``b``'s backward bitstream (after the table
    descriptors) in bytes ``[byte_start, + n_bytes)``; rows: (B, 3) int64
    (``DECODE_COLS``, ``bits_left0`` the sentinel's bit position);
    seq_off: (B + 1,) int64 cumulative sequence counts from 0; al: (B, 3)
    int32 and tables: (B, 3, 512) int32 (:func:`pack_decode_table`), both in
    (ll, of, ml) order.  Initial states read LL, OF, ML; each step reads the
    OF extra bits, then ML and LL in one window, then (but on the last
    sequence) the LL, ML and OF state bits; reads below bit 0 give zeros.

    Returns ``(lls, mls, ovs)``, each (seq_off[-1],) int32 (``ovs`` the raw
    offset values), ``pos_f`` (B,) int32, 0 for a fully consumed stream,
    and ``err`` (B,) bool, set where an offset code exceeds 30.  ``shape``
    is the wrapper's, unused here."""
    _check_decode(payload, rows, seq_off, al, tables)
    dev = payload.device
    i64 = torch.int64
    B = rows.shape[0]
    total = int(seq_off[-1])
    pos = rows[:, 2].clone()
    n = seq_off[1:] - seq_off[:-1]
    N = int(n.max()) if B else 0
    if N == 0:
        empty = torch.zeros(total, dtype=torch.int32, device=dev)
        return (empty, empty.clone(), empty.clone(), pos.to(torch.int32),
                torch.zeros(B, dtype=torch.bool, device=dev))
    start, nbytes = rows[:, 0], rows[:, 1]
    # each block's bytes behind 4 zero bytes; w40[b, j]: bytes j..j+4 as one
    # little-endian integer, so a read of up to 32 bits at any shift is one
    # gather (padded bit k = real bit k - 32, as fse_jax's read_bits)
    P = int(nbytes.max())
    k = torch.arange(P, device=dev)
    ok = k < nbytes[:, None]
    body = torch.where(ok, payload[torch.where(ok, start[:, None] + k, 0)].to(i64), 0)
    buf = torch.nn.functional.pad(body, (4, 8))
    w40 = sum(buf[:, j:j + P + 8] << (8 * j) for j in range(5)).reshape(-1)
    row0 = torch.arange(B, device=dev) * (P + 8)

    def read(pos, nb):  # pos, nb: (..., B)
        kk = (pos + 32).clamp(min=0)
        return (w40[row0 + (kk >> 3)] >> (kk & 7)) & ((1 << nb) - 1)

    al64 = al.to(i64)
    states = []
    for c in range(3):  # LL, OF, ML
        pos = pos - al64[:, c]
        states.append(read(pos, al64[:, c]))
    state = torch.stack(states, 1)
    tab = tables.to(i64).reshape(B, 3 * TABLE)
    lane = torch.arange(3, device=dev) * TABLE
    # extra-bit counts by code, codes past the alphabets read as its last
    ml_bits_of = torch.from_numpy(_ML_BITS_NP[np.minimum(np.arange(64), 52)]).to(dev).to(i64)
    ll_bits_of = torch.from_numpy(_LL_BITS_NP[np.minimum(np.arange(64), 35)]).to(dev).to(i64)
    act = torch.arange(N, device=dev)[:, None] < n  # (N, B)
    upd = torch.arange(1, N + 1, device=dev)[:, None] < n
    syms = torch.zeros((N, B, 3), dtype=i64, device=dev)
    pos_v = torch.zeros((N, B), dtype=i64, device=dev)  # below a step's value bits
    # the chain: codes and bit counts step by step; the values are read after
    for i in range(N):
        e = tab.gather(1, state + lane)
        sym = torch.where(act[i, :, None], e & 0x3F, 0)  # ll, of, ml
        syms[i] = sym
        pos = pos - sym[:, 1].clamp(max=30) - ml_bits_of[sym[:, 2]] - ll_bits_of[sym[:, 0]]
        pos_v[i] = pos
        nbu = torch.where(upd[i, :, None], (e >> 6) & 0x3FF, 0)
        tot = nbu.sum(1)
        pos = pos - tot
        wu = read(pos, tot)
        of_x = wu & ((1 << nbu[:, 1]) - 1)
        wu = wu >> nbu[:, 1]
        x = torch.stack([wu >> nbu[:, 2], of_x, wu & ((1 << nbu[:, 2]) - 1)], 1)
        state = torch.where(upd[i, :, None], (e >> 16) + x, state)
    # the values, all steps at once: OF extra bits, then ML above LL
    llc, ofc, mlc = syms.unbind(2)
    err = (ofc > 30).any(0)
    ofc = ofc.clamp(max=30)
    mlc, llc = mlc.clamp(max=52), llc.clamp(max=35)
    ml_b, ll_b = ml_bits_of[mlc], ll_bits_of[llc]
    ov = torch.where(ofc > 0, (1 << ofc) + read(pos_v + ml_b + ll_b, ofc), 1)
    w = read(pos_v, ml_b + ll_b)
    ml_v = torch.from_numpy(_ML_BASE_NP).to(dev).to(i64)[mlc] + (w >> ll_b)
    ll_v = torch.from_numpy(_LL_BASE_NP).to(dev).to(i64)[llc] + (w & ((1 << ll_b) - 1))
    valid = act.T
    return (*(v.T[valid].to(torch.int32) for v in (ll_v, ml_v, ov)), pos.to(torch.int32), err)


def decode_seq_streams(payload, rows, seq_off, al, tables, *, shape=None):
    """:func:`decode_seq_streams_plain` on the CPU; on a GPU, the CUDA
    decoder (``csrc/fse_decode.cu``).  Same inputs, same outputs, for rows
    whose sentinel lies in their bytes (``bits_left0 < 8 * n_bytes``, as
    :func:`build_decode_batch` makes them) and tables of
    :func:`pack_decode_table`; a row outside the payload or with its
    sentinel above its bytes gets ``pos_f`` -1 and ``err``.

    The kernel stages each row of up to :data:`STAGE_CAP` bytes in shared
    memory, sized from the batch's longest row, and reads a longer one from
    global memory; it keeps one record of 8 bytes a sequence in a scratch.
    Its bit positions are int32: a block of ``2**23`` sequences or more, or
    a row of ``2**26`` bytes or more, raises ValueError.

    ``shape``, ``(seq_off[-1], the longest row's bytes, the most sequences
    of a block)`` where the host knows them (:func:`decode_shape`), sizes
    the outputs and the stage without a read-back; without it the wrapper
    reads them back, one device-to-host copy."""
    args = (payload, rows, seq_off, al, tables)
    if payload.device.type == "cpu":
        return decode_seq_streams_plain(*args)
    if payload.device.type != "cuda":
        raise ValueError("decode_seq_streams takes CPU or CUDA tensors")
    _check_decode(*args)
    for name, t in zip(DECODE_ARGS, args):
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {payload.device}")
    B = rows.shape[0]
    i32, dev = torch.int32, payload.device
    if shape is not None:
        total, widest, longest = shape
    else:
        with metrics.phase("torch.fse_decode.wait", 32 if B else 8):
            total, widest, longest = int(seq_off[-1]), 0, 0
            if B:  # one read-back: the output size, the stage size, the longest chain
                total, widest, longest = torch.stack(
                    [seq_off[-1], rows[:, 1].max(), (seq_off[1:] - seq_off[:-1]).max()]).tolist()
    if longest >= 1 << 23 or widest >= 1 << 26:
        raise ValueError("a block of 2**23 sequences or a row of 2**26 bytes is beyond the "
                         "kernel's int32 bit positions")
    lls, mls, ovs = (torch.empty(total, dtype=i32, device=dev) for _ in range(3))
    rec = torch.empty((total, 2), dtype=i32, device=dev)
    pos_f = torch.empty(B, dtype=i32, device=dev)
    err = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return lls, mls, ovs, pos_f, err
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.zp_fse_decode(
            payload.data_ptr(), payload.numel(), rows.data_ptr(), seq_off.data_ptr(),
            al.data_ptr(), tables.data_ptr(), B, int(longest > 0), min(max(widest, 0), STAGE_CAP),
            rec.data_ptr(), lls.data_ptr(), mls.data_ptr(), ovs.data_ptr(), pos_f.data_ptr(),
            err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fse_decode")
    launched("fse_decode")
    return lls, mls, ovs, pos_f, err


def decode_shape(rows: np.ndarray, seq_off: np.ndarray) -> tuple[int, int, int]:
    """:func:`decode_seq_streams`' ``shape`` of a batch's host arrays."""
    if not len(rows):
        return int(seq_off[-1]), 0, 0
    return int(seq_off[-1]), int(rows[:, 1].max()), int(np.diff(seq_off).max())


def build_decode_batch(items: list[tuple]) -> dict:
    """The flat batch of :func:`decode_seq_streams` as numpy arrays
    (``payload``, ``rows``, ``seq_off``, ``al``, ``tables``) from items
    ``(bitstream, ll_table, of_table, ml_table, nb_seq)``.  Raises
    DecompressError, as ``DeviceSequenceDecoder`` does, for a bitstream
    with no sentinel bit."""
    for it in items:
        bs = it[0]
        if not bs or bs[-1] == 0:
            raise DecompressError("corrupt backward bitstream (no sentinel)")
    nbytes = np.array([len(it[0]) for it in items], dtype=np.int64)
    bl0 = np.array([(len(it[0]) - 1) * 8 + it[0][-1].bit_length() - 1 for it in items],
                   dtype=np.int64)
    packed: dict[int, np.ndarray] = {}
    tabs = np.zeros((len(items), 3, TABLE), dtype=np.int32)
    al = np.zeros((len(items), 3), dtype=np.int32)
    for i, it in enumerate(items):
        for c, t in enumerate(it[1:4]):  # ll, of, ml
            if id(t) not in packed:
                packed[id(t)] = pack_decode_table(t)
            tabs[i, c] = packed[id(t)]
            al[i, c] = t.al
    ns = np.array([it[4] for it in items], dtype=np.int64)
    return {"payload": np.frombuffer(bytearray(b"".join(it[0] for it in items)), dtype=np.uint8),
            "rows": np.stack([np.cumsum(nbytes) - nbytes, nbytes, bl0], axis=1).reshape(-1, 3),
            "seq_off": np.concatenate([[0], np.cumsum(ns)]).astype(np.int64),
            "al": al, "tables": tabs}



class TorchSequenceDecoder:
    """Host wrapper for the batched sequence decode: batches the backward
    bitstreams and their tables, decodes them on ``device`` in one launch
    and checks that each stream was consumed exactly.  The device analog of
    ``fse_jax.DeviceSequenceDecoder``, bit-exact vs
    ``seq.decode_sequences``.

    ``device`` may be a ``DeviceMesh``: the items split into contiguous
    ranges, one a mesh device, each decoded in one launch on its device
    with the whole table rows (its range a view of them); the values
    gather on the first mesh device in item order, and the flags of every
    shard are checked in item order, so an error names the same first bad
    item whatever the shard count."""

    def __init__(self, device):
        self.mesh = as_mesh(device)
        self.device = self.mesh.devices[0]

    def decode_batch_device(self, items: list[tuple]):
        """items[i] = (bitstream bytes, ll_table, of_table, ml_table,
        nb_seq).  Returns ``((lls, mls, ovs), seq_off)``: flat int32
        tensors on the device (raw offset values, before repeat-offset
        resolution), block i's at ``[seq_off[i], seq_off[i + 1])``, and
        ``seq_off`` as numpy.  Raises DecompressError, with the messages of
        ``DeviceSequenceDecoder``, for an offset code above 30 and a stream
        not consumed exactly."""
        return self.decode_built(build_decode_batch(items))

    def decode_built(self, batch: dict):
        """:meth:`decode_batch_device` on a batch of
        :func:`build_decode_batch`, or one made alike: its ``payload`` may be
        a uint8 tensor, on the device or not, such as the whole entry the
        rows point into, rows in ascending order of their bytes."""
        rows, seq_off = batch["rows"], batch["seq_off"]
        with metrics.phase("torch.fse_decode.wait"):  # a blocking upload
            tabs = {d: torch.from_numpy(batch["tables"]).to(d) for d in self.mesh.distinct()}
        launched = []
        for (lo, hi), dev in zip(row_ranges(len(rows), self.mesh.size), self.mesh.devices):
            if lo == hi:
                continue
            part = rows[lo:hi].copy()
            p0, p1 = part[0, 0], part[-1, 0] + part[-1, 1]
            part[:, 0] -= p0
            with metrics.phase("torch.fse_decode.wait"):  # blocking uploads
                args = (torch.as_tensor(batch["payload"][p0:p1]).to(dev),
                        torch.from_numpy(part).to(dev),
                        torch.from_numpy(seq_off[lo:hi + 1] - seq_off[lo]).to(dev),
                        torch.from_numpy(batch["al"][lo:hi]).to(dev))
            launched.append(decode_seq_streams(*args, tabs[dev][lo:hi]))
        # one copy a shard
        flags = [torch.cat([f[3], f[4].to(torch.int32)]) for f in launched]
        with metrics.phase("torch.fse_decode.wait", sum(f.nbytes for f in flags)):
            flags = [f.cpu().numpy() for f in flags]
        pos_f = np.concatenate([f[:len(f) // 2] for f in flags])
        err = np.concatenate([f[len(f) // 2:] for f in flags])
        if err.any():
            raise DecompressError("offset code out of device range")
        bad = np.flatnonzero((np.diff(seq_off) > 0) & (pos_f != 0))  # in item order
        if bad.size:
            raise DecompressError("sequence bitstream not fully consumed"
                                  if pos_f[bad[0]] > 0 else "sequence bitstream over-read")
        if len(launched) == 1:
            return launched[0][:3], seq_off
        return tuple(torch.cat([f[c].to(self.device) for f in launched])
                     for c in range(3)), seq_off

    def decode_batch(self, items: list[tuple]) -> tuple:
        """Returns (lls, mls, ovs), each a list of np arrays (raw offset
        values, before repeat-offset resolution)."""
        if not items:
            return [], [], []
        flat, seq_off = self.decode_batch_device(items)
        cuts = seq_off.tolist()
        return tuple([a[s:e] for s, e in zip(cuts[:-1], cuts[1:])]
                     for a in (t.cpu().numpy() for t in flat))


# ---------------------------------------------------------------------------
# Repeat offsets (counterpart of fse_jax.py:484-566)
# ---------------------------------------------------------------------------


def seq_maps(ovs, lls):
    """Each sequence's repeat-offset update as a map out_j = in[sel_j] +
    val_j, or val_j where sel_j = 3: the seven cases of
    ``fse_jax.rep_prefix_maps``.  Returns sel (..., 3) int64 and val
    (..., 3) int32."""
    litz = lls == 0
    new = ovs > 3
    c2 = (~litz & (ovs == 2)) | (litz & (ovs == 1))  # (r1, r0, r2)
    c3 = (~litz & (ovs == 3)) | (litz & (ovs == 2))  # (r2, r0, r1)
    cd = litz & (ovs == 3)                           # (r0 - 1, r0, r1)
    sel0 = torch.where(new, 3, torch.where(c2, 1, torch.where(c3, 2, 0)))
    val0 = torch.where(new, ovs.to(torch.int32) - 3, torch.where(cd, -1, 0).to(torch.int32))
    sel1 = torch.where(new | c2 | c3 | cd, 0, 1)
    sel2 = torch.where(new | c3 | cd, 1, 2)
    zero = torch.zeros_like(val0)
    return torch.stack([sel0, sel1, sel2], -1), torch.stack([val0, zero, zero], -1)


def _after(a_sel, a_val, b_sel, b_val):
    """The map ``b`` applied after ``a`` (int32 values wrap, as in XLA)."""
    const = b_sel == 3
    bs = b_sel.clamp(max=2)
    return (torch.where(const, 3, a_sel.gather(-1, bs)),
            torch.where(const, b_val, a_val.gather(-1, bs) + b_val))


def _padded(seq_off):
    """The (B, N) view of flat per-block sequences: which lanes are valid,
    and each lane's flat index (0 for padding)."""
    n = seq_off[1:] - seq_off[:-1]
    N = max(int(n.max()) if n.numel() else 0, 1)
    k = torch.arange(N, device=seq_off.device)
    valid = k < n[:, None]
    return valid, torch.where(valid, seq_off[:-1, None] + k, 0)


def _prefix_maps(ovs, lls, seq_off):
    """Inclusive prefix compositions (B, N, 3) of every block's sequence
    maps, identity past ``nb_seq``, by Hillis-Steele doubling over
    gathers (torch has no associative scan); plus the (B, N) valid mask."""
    valid, idx = _padded(seq_off)
    B, N = valid.shape
    ident = torch.arange(3, device=ovs.device).expand(B, N, 3)
    if ovs.numel() == 0:
        return ident, torch.zeros((B, N, 3), dtype=torch.int32, device=ovs.device), valid
    sel, val = seq_maps(ovs[idx], lls[idx])
    sel = torch.where(valid[..., None], sel, ident)
    val = torch.where(valid[..., None], val, 0)
    d = 1
    while d < N:
        prev_sel = torch.cat([ident[:, :d], sel[:, :-d]], 1)
        prev_val = torch.cat([torch.zeros_like(val[:, :d]), val[:, :-d]], 1)
        sel, val = _after(prev_sel, prev_val, sel, val)
        d *= 2
    return sel, val, valid


def _check_rep(ovs, lls, seq_off, *more) -> None:
    if seq_off.dtype != torch.int64 or seq_off.dim() != 1 or seq_off.shape[0] < 1:
        raise ValueError("seq_off must be (B + 1,) int64")
    for name, t in (("ovs", ovs), ("lls", lls), *more):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a flat int32 tensor")


def rep_totals_plain(ovs, lls, mls, seq_off):
    """Per block, the composition of all its sequences' repeat-offset maps
    (the map of ``fse_jax.rep_prefix_maps`` at ``nb_seq - 1``; identity
    for an empty block) and the sums of its literal and match lengths.

    ovs, lls, mls: flat int32, block ``b``'s sequences at ``[seq_off[b],
    seq_off[b + 1])``, ``seq_off`` from 0.  Returns sel (B, 3) int32, val
    (B, 3) int32, sums (B, 2) int64 ``(sum_ll, sum_ml)``."""
    _check_rep(ovs, lls, seq_off, ("mls", mls))
    sel, val, _ = _prefix_maps(ovs, lls, seq_off)
    last = (seq_off[1:] - seq_off[:-1] - 1).clamp(min=0)[:, None, None].expand(-1, 1, 3)
    valid, idx = _padded(seq_off)
    sums = torch.zeros((valid.shape[0], 2), dtype=torch.int64, device=ovs.device)
    if ovs.numel():
        sums = torch.stack([torch.where(valid, t[idx].to(torch.int64), 0).sum(1)
                            for t in (lls, mls)], 1)
    return (sel.gather(1, last)[:, 0].to(torch.int32), val.gather(1, last)[:, 0], sums)


def rep_apply_plain(ovs, lls, seq_off, entry):
    """Resolved offsets: r0 of each sequence's inclusive prefix map applied
    to its block's entry rep state ``entry`` (B, 3) int32
    (``fse_jax.apply_rep_maps``).  Returns offsets (seq_off[-1],) int32 and
    err (B,) bool, set where a block resolves an offset <= 0."""
    _check_rep(ovs, lls, seq_off, ("entry", entry.reshape(-1)))
    sel, val, valid = _prefix_maps(ovs, lls, seq_off)
    e = entry[:, None, :].expand(-1, valid.shape[1], 3)
    picked = e.gather(-1, sel[..., :1].clamp(max=2))[..., 0]
    off = torch.where(sel[..., 0] == 3, val[..., 0], picked + val[..., 0])
    return off[valid], (valid & (off <= 0)).any(1)


#: sequences a tile of the CUDA scan (``kThreads`` in ``csrc/rep_resolve.cu``),
#: one a thread; the tests put block lengths on both sides of it
REP_TILE = 1024


def _rep_launch(name: str, tensors: tuple, outs: tuple, B: int) -> None:
    """Launch ``name``, ``rep_totals`` or ``rep_apply``: the two entry points of
    ``csrc/rep_resolve.cu``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on {dev}")
    if B == 0:
        return
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"zp_{name}")(*(t.data_ptr() for t in tensors), B,
                                        *(t.data_ptr() for t in outs),
                                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    launched(name)


def rep_totals(ovs, lls, mls, seq_off):
    """:func:`rep_totals_plain` on the CPU; on a GPU, the CUDA scan, one CTA
    per block (``csrc/rep_resolve.cu``).  Same inputs, same outputs."""
    if ovs.device.type == "cpu":
        return rep_totals_plain(ovs, lls, mls, seq_off)
    if ovs.device.type != "cuda":
        raise ValueError("rep_totals takes CPU or CUDA tensors")
    _check_rep(ovs, lls, seq_off, ("mls", mls))
    B = seq_off.shape[0] - 1
    sel = torch.empty((B, 3), dtype=torch.int32, device=ovs.device)
    val = torch.empty_like(sel)
    sums = torch.empty((B, 2), dtype=torch.int64, device=ovs.device)
    _rep_launch("rep_totals", (ovs, lls, mls, seq_off), (sel, val, sums), B)
    return sel, val, sums


def rep_apply(ovs, lls, seq_off, entry):
    """:func:`rep_apply_plain` on the CPU; on a GPU, the CUDA scan, one CTA
    per block (``csrc/rep_resolve.cu``).  Same inputs, same outputs."""
    if ovs.device.type == "cpu":
        return rep_apply_plain(ovs, lls, seq_off, entry)
    if ovs.device.type != "cuda":
        raise ValueError("rep_apply takes CPU or CUDA tensors")
    _check_rep(ovs, lls, seq_off, ("entry", entry.reshape(-1)))
    B = seq_off.shape[0] - 1
    if entry.shape != (B, 3):
        raise ValueError("entry must be (B, 3) int32")
    offs = torch.empty_like(ovs)
    err = torch.empty(B, dtype=torch.bool, device=ovs.device)
    _rep_launch("rep_apply", (ovs, lls, seq_off, entry), (offs, err), B)
    return offs, err


def eval_rep_map(sel, val, entry):
    """Host-side apply of one map row (3,) to an entry triple — the
    per-block stitching step.  Copy of ``fse_jax.eval_rep_map``."""
    out = []
    for j in range(3):
        s, v = int(sel[j]), int(val[j])
        out.append(v if s == 3 else int(entry[s]) + v)
    return out
