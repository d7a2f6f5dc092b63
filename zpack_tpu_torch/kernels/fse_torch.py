"""zstd FSE sequence-section encode for PyTorch.

Counterpart of the encode half of ``zpack_tpu/kernels/fse_jax.py``
(``encode_seq_streams`` with ``_init_state``, and
``DeviceSequenceEncoder``).  The kernel has two halves:

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

import numpy as np
import torch

from zpack_tpu.codecs.zstd import seq as zseq

from . import _build
from .huffman_torch import scatter_bits

#: max symbols of any sequence-code alphabet (ML has 53) padded to a lane
NSYM = 64
#: max FSE table size: 1 << max(LL_MAX_AL, ML_MAX_AL, OF_MAX_AL) = 1 << 9
TABLE = 512
#: one packed table row: state table, delta_nb_bits, delta_find_state
ROW = TABLE + 2 * NSYM

#: launches of the hand-written kernel, counted by its wrapper only
LAUNCHES = {"fse_encode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    lib = _build.lib()
    with torch.cuda.device(fields.device):
        rc = lib.zp_fse_encode(
            fields.data_ptr(), seq_off.data_ptr(), tables.data_ptr(), al.data_ptr(),
            word_off.data_ptr(), B, words.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(fields.device).cuda_stream)
    _build.check(rc, "fse_encode")
    LAUNCHES["fse_encode"] += 1
    return words, total


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
    device analog of ``fse_jax.DeviceSequenceEncoder``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def encode_batch(self, blocks: list[tuple], tables: list[tuple]) -> list[bytes]:
        """blocks[i] = (lls, mls, ovs) int arrays (non-empty); tables[i] =
        (ll_table, of_table, ml_table) from ``_pick_table``.  Returns each
        block's sequences bitstream."""
        if not blocks:
            return []
        batch = build_batch(blocks, tables)
        words, total = encode_seq_streams(
            *(torch.from_numpy(batch[k]).to(self.device) for k in BATCH_ARGS),
            n_words=batch["n_words"])
        total = total.cpu().numpy()
        plane = words.cpu().numpy().tobytes()
        off = batch["word_off"]
        return [plane[4 * int(off[i]): 4 * int(off[i]) + (int(total[i]) + 8) // 8]
                for i in range(len(blocks))]
