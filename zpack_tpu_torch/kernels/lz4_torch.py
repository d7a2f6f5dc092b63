"""LZ4 device kernels for PyTorch: the match finder, the block parse and the
sequence replay.

Counterpart of ``zpack_tpu/kernels/lz4_jax.py`` and
``zpack_tpu/kernels/lz4_pallas.py``.  Each kernel has two halves:

* a plain version (``tokenize_plain``, ``build_batch``, ``replay_plain``)
  that states the contract;
* a wrapper (``tokenize``, ``parse_batch``, ``replay``) that takes the plain
  version for a tensor on the CPU and launches the hand-written CUDA kernel
  (``zpack_tpu_torch/csrc/*.cu``) for a tensor on a GPU.  It never falls
  back: a build or launch error raises.

The block parse has no TPU original: the JAX package walks the tokens on
the host.  ``build_batch`` is that walk; ``parse_batch`` runs it on the card
(``csrc/lz4_parse.cu``) and returns the same tables there.

The match finder has one matcher and four last steps, the wire formats of
the JAX package's tokenizers (:data:`MODES`): "pair" (``tokenize_block_resort``,
position-ordered ``src`` uint16, 0 where there is no match, and ``code``
uint8 = ``mlen - 3``, 0 = no match; what the native serializer takes at 64
KiB blocks), "u16" (``tokenize_block_u16``, one uint16 ``src << 3 | code`` per
byte, for windows of 8 KiB or less), "hash" (``tokenize_block_noscatter`` and
the Pallas kernel: hash-ordered ``(pos, mlen << 17 | src)`` int32) and
"scatter" (``tokenize_block``: ``src`` int32, -1 = none, and ``mlen`` int32).
:func:`from_jax_wire` turns any of them into the standard ``(src int32, -1 =
none; mlen int32)`` tables.  Every launch also returns the size estimate of
its rows (:func:`est_plain`).
"""

from __future__ import annotations

import bisect
import ctypes
import struct

import numpy as np
import torch

from ..codecs.lz4 import block as lz4block
from ..errors import DecompressError
from ..utils.observe import launched, metrics

from . import _build

MIN_MATCH = 4
MFLIMIT = 12
LAST_LITERALS = 5
#: match-length cap of the main path (the JAX "pair" default, n_words=2);
#: the Pallas kernel's own contract is 16
CAPJ = 8
#: the longest comparison of a candidate the match finder takes ("pair"
#: holds lengths up to 258, "u16" up to 10)
CAPJ_MAX = 32
#: the deepest hash chain an LZ4 high-compression level walks: the match
#: finder's most, at which level 9's create kept within 10% of the greedy
#: parse's at depth 8 on an H100
HC_DEPTH_CAP = 64
#: an HC level's candidate comparison, by wire format: the longest each
#: holds ("u16" packs a length in 3 bits)
HC_CAPJ = {"pair": CAPJ_MAX, "u16": 10}
_HASH_MUL = 2654435761


def hc_depth(level: int) -> int:
    """The match finder's chain depth at an LZ4 high-compression level
    (3 and up): LZ4HC's search attempts, ``1 << (level - 1)``, at least
    the JAX engine's 8 and at most :data:`HC_DEPTH_CAP`, which levels 7
    and up reach.  Levels 10 to 12, LZ4's optimal parser, take level 9's
    parse and depth: the card has no optimal parser."""
    return min(max(8, 1 << (level - 1)), HC_DEPTH_CAP)

#: the tokenizer's wire formats, in the order of the kernel's mode argument
MODES = ("pair", "u16", "hash", "scatter")


def launch_key(mode: str) -> str:
    """The kernel name a tokenizer launch in ``mode`` is recorded under
    (``launch.<name>``; "pair" is the main path's ``lz4_tokenize``).  Every
    tokenizer launch also reduces its rows' size estimate, so the
    estimate's launches are the sum of the four modes'.  The parse records
    one ``lz4_parse`` a batch (its walk and its layout), the replay one
    ``lz4_replay`` a launch."""
    return "lz4_tokenize" if mode == "pair" else f"lz4_tokenize_{mode}"


# ---------------------------------------------------------------------------
# Match finder
# ---------------------------------------------------------------------------


def _check_tokenize(blocks: torch.Tensor, depth: int, capj: int, mode: str = "pair",
                    dict_pad: int = 0) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError("blocks must be a (nb, W) uint8 tensor")
    W = blocks.shape[1]
    if not 1 <= W <= 65536:
        raise ValueError(f"window {W} outside 1..65536")
    if not 1 <= depth <= 64:
        raise ValueError(f"depth {depth} outside 1..64")
    if not MIN_MATCH <= capj <= CAPJ_MAX:
        raise ValueError(f"capj {capj} outside 4..{CAPJ_MAX}")
    if mode not in MODES:
        raise ValueError(f"unknown wire mode {mode!r}")
    if not 0 <= dict_pad < W:
        raise ValueError(f"dict_pad {dict_pad} outside 0..{W - 1}")
    if mode == "u16" and capj > 10:
        raise ValueError(f"mode 'u16' packs mlen - 3 into 3 bits: capj {capj} > 10")
    if mode == "u16" and W > 8192:
        raise ValueError(f"mode 'u16' packs src into 13 bits: window {W} > 8192")
    if mode == "hash" and dict_pad:
        raise ValueError("mode 'hash' takes no dictionary window")


def tokenize_plain(blocks: torch.Tensor, depth: int = 2, capj: int = CAPJ,
                   mode: str = "pair", dict_pad: int = 0):
    """LZ4 match finding for a batch of windows, in plain PyTorch.

    Each row of ``blocks`` is a window of W bytes (zero past W): ``dict_pad``
    bytes of a shared dictionary, then the block.  Hash every 4-byte window,
    sort the keys ``(h << 16) | p``, take the ``depth`` nearest earlier
    positions with the same hash as candidates, score each by its leading
    equal bytes capped at ``capj`` (under 4 counts as 0; the strictly
    longest wins, so on a tie the nearest), then apply the LZ4 end-of-block
    rules at the end of the window.  The last step is the wire format
    ``mode``; all but "hash" keep the data positions ``p >= dict_pad`` only,
    at column ``p - dict_pad``, with ``src`` relative to the window start:

    * ``"pair"``: ``(src uint16, code uint8)``, each (nb, W - dict_pad); same
      function as ``lz4_jax.tokenize_block_resort`` at capj=8;
    * ``"u16"``: ``(tok uint16,)``, ``src << 3 | (mlen - 3)``, 0 = no match
      (W <= 8192, capj <= 10): ``lz4_jax.tokenize_block_u16``;
    * ``"hash"``: hash-ordered ``(pos int32, mlen << 17 | (src & 0x1FFFF)
      int32)``, each (nb, W), ``src`` -1 where there is no match:
      ``lz4_jax.tokenize_block_noscatter`` at ``capj = 4 * n_words``, and
      ``lz4_pallas.tokenize_blocks_device`` at 16;
    * ``"scatter"``: ``(src int32, -1 = none; mlen int32, 0 = none)``:
      ``lz4_jax.tokenize_block`` at capj=16."""
    _check_tokenize(blocks, depth, capj, mode, dict_pad)
    nb, B = blocks.shape
    dev = blocks.device
    bp = torch.cat([blocks, blocks.new_zeros((nb, capj + 4))], dim=1)
    b = bp.to(torch.int64)
    u = b[:, :B] | (b[:, 1:B + 1] << 8) | (b[:, 2:B + 2] << 16) | (b[:, 3:B + 3] << 24)
    h = ((u * _HASH_MUL) & 0xFFFFFFFF) >> 16
    pos = torch.arange(B, device=dev, dtype=torch.int64)
    key_s, _ = torch.sort((h << 16) | pos, dim=1)
    hs = key_s >> 16
    ps = key_s & 0xFFFF
    # window bytes p..p+capj-1, gathered into the sorted order
    win = [bp[:, i:i + B].gather(1, ps) for i in range(capj)]

    best_len = torch.zeros((nb, B), dtype=torch.int64, device=dev)
    best_src = torch.zeros_like(best_len)
    for d in range(1, min(depth, B - 1) + 1):
        # a same-hash row d above holds an earlier position at most 65535
        # back: keys are unique and B <= 65536
        same = hs[:, d:] == hs[:, :-d]
        cand = ps[:, :-d]
        run = torch.zeros((nb, B - d), dtype=torch.int64, device=dev)
        alive = torch.ones_like(same)
        for w in win:
            alive &= w[:, d:] == w[:, :-d]
            run += alive
        mlen = torch.where(same & (run >= MIN_MATCH), run, 0)
        better = mlen > best_len[:, d:]
        best_len[:, d:] = torch.where(better, mlen, best_len[:, d:])
        best_src[:, d:] = torch.where(better, cand, best_src[:, d:])

    ok = (best_len >= MIN_MATCH) & (ps < B - MFLIMIT) & (ps > 0)
    ml = torch.minimum(best_len, (B - LAST_LITERALS) - ps)
    ok &= ml >= MIN_MATCH
    ml = torch.where(ok, ml, 0)
    if mode == "hash":
        packed = (ml << 17) | (torch.where(ok, best_src, -1) & 0x1FFFF)
        return ps.to(torch.int32), packed.to(torch.int32)
    # int64 throughout: the CPU has no uint16 scatter
    src = torch.empty_like(ps).scatter_(1, ps, torch.where(ok, best_src, 0))[:, dict_pad:]
    ml = torch.empty_like(ps).scatter_(1, ps, ml)[:, dict_pad:]
    code = torch.where(ml > 0, ml - 3, 0)
    if mode == "pair":
        return src.to(torch.uint16), code.to(torch.uint8)
    if mode == "u16":
        return (((src << 3) | code).to(torch.uint16),)
    return torch.where(ml > 0, src, -1).to(torch.int32), ml.to(torch.int32)


def est_plain(arrays, mode: str) -> torch.Tensor:
    """The size estimate of ``pipeline._step_fn.local_step`` (``_est``) from
    a tokenizer's outputs in wire format ``mode``: over the rows' data
    positions, ``sum(B - sum(mlen) + 3 * count(mlen >= 4))``, B the row
    length: literals plus three bytes a match.  A (1,) int64 tensor.

    The JAX step also counts its padding rows (``_steps_raw`` pads every
    step to a fixed count of zero rows, and a zero row matches itself); this
    function counts the rows it is given, and the port has no padding rows.
    The two agree on an input whose block count fills the JAX steps."""
    a = arrays[-1].to(torch.int64)
    if mode == "hash":
        mlen = a >> 17
    elif mode == "scatter":
        mlen = a
    else:
        code = a & 7 if mode == "u16" else a
        mlen = torch.where(code > 0, code + 3, 0)
    hit = mlen >= MIN_MATCH
    est = a.numel() - torch.where(hit, mlen, 0).sum() + 3 * hit.sum()
    return est.reshape(1)


#: windows up to this many bytes run in the kernel's small shape (256
#: threads, everything in shared memory; ``kSmallWindow`` in
#: ``csrc/lz4_tokenize.cu``); larger ones take a uint16 scratch a position
TOKENIZE_SMALL_WINDOW = 16384

#: the element types of each wire format's arrays
WIRE_DTYPES = {"pair": (torch.uint16, torch.uint8), "u16": (torch.uint16,),
               "hash": (torch.int32, torch.int32), "scatter": (torch.int32, torch.int32)}


def tokenize_est(blocks: torch.Tensor, depth: int = 2, capj: int = CAPJ,
                 mode: str = "pair", dict_pad: int = 0):
    """``(arrays, est)``: :func:`tokenize_plain` and :func:`est_plain` on the
    CPU; on a GPU, one launch of the CUDA match finder
    (``csrc/lz4_tokenize.cu``: a stable radix order of the positions by
    their hash, a hash-chain table in shared memory, outputs stored in
    position order), which writes the wire format ``mode`` and reduces the
    estimate in its own body.  Same inputs, same outputs."""
    if blocks.device.type == "cpu":
        arrays = tokenize_plain(blocks, depth, capj, mode, dict_pad)
        return arrays, est_plain(arrays, mode)
    _check_tokenize(blocks, depth, capj, mode, dict_pad)
    if blocks.device.type != "cuda" or not blocks.is_contiguous():
        raise ValueError("tokenize takes a contiguous CPU or CUDA tensor")
    nb, W = blocks.shape
    cols = W if mode == "hash" else W - dict_pad
    arrays = tuple(torch.empty((nb, cols), dtype=t, device=blocks.device)
                   for t in WIRE_DTYPES[mode])
    est = torch.zeros(1, dtype=torch.int64, device=blocks.device)
    if nb == 0:
        return arrays, est
    # the sorted order of a large window's positions: every other shape
    # keeps it in shared memory, and "hash" sorts into its ``pos`` output
    order = None
    if W > TOKENIZE_SMALL_WINDOW and mode != "hash":
        order = torch.empty((nb, W), dtype=torch.int16, device=blocks.device)
    lib = _build.lib()
    with torch.cuda.device(blocks.device):
        rc = lib.zp_lz4_tokenize(
            blocks.data_ptr(), nb, W, dict_pad, depth, capj, MODES.index(mode),
            None if order is None else order.data_ptr(), arrays[0].data_ptr(),
            arrays[1].data_ptr() if len(arrays) > 1 else None, est.data_ptr(),
            torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check(rc, "lz4_tokenize")
    launched(launch_key(mode))
    return arrays, est


def tokenize(blocks: torch.Tensor, depth: int = 2, capj: int = CAPJ,
             mode: str = "pair", dict_pad: int = 0):
    """The wire arrays of :func:`tokenize_est` without the estimate."""
    return tokenize_est(blocks, depth, capj, mode, dict_pad)[0]


def unpack_resort_host(src16: np.ndarray, code: np.ndarray):
    """Split the pair wire format (src u16, code u8) into the standard
    (src, mlen) int32 tables (vectorized, any leading shape).  Copy of
    ``lz4_jax.unpack_resort_host``."""
    code = np.asarray(code).astype(np.int32)
    mlen = np.where(code > 0, code + 3, 0).astype(np.int32)
    src = np.where(code > 0, np.asarray(src16).astype(np.int32), -1).astype(np.int32)
    return src, mlen


def parse_events_host(src: np.ndarray, mlen: np.ndarray, n: int):
    """Greedy parse via numpy pointer-doubling over the device jump table.
    Returns sorted match positions (the parse orbit's match events).  Copy
    of ``lz4_jax.parse_events_host``."""
    B = len(mlen)
    step = np.where(mlen >= MIN_MATCH, mlen, 1).astype(np.int64)
    jump = np.minimum(np.arange(B, dtype=np.int64) + step, B)
    jump = np.concatenate([jump, [B]])
    orbit = np.array([0], dtype=np.int64)
    while len(orbit) <= B:
        orbit = np.concatenate([orbit, jump[orbit]])
        jump = jump[jump]
    orbit = orbit[: B + 1]
    events = orbit[orbit < n]
    events = np.unique(events)  # orbit is sorted+padded; dedupe the fixpoint
    return events[mlen[events] >= MIN_MATCH]


def _extend_capped(arr: np.ndarray, limit: int, p: np.ndarray, j: np.ndarray,
                   ml: np.ndarray) -> np.ndarray:
    """Exact-extend capped match lengths, vectorized: strip-doubling compares
    of (n_active, s) byte blocks; rows retire at their first mismatch or at
    ``limit``.  Total work is O(sum of extensions).  Copy of
    ``lz4_jax._extend_capped``."""
    pe = (p + ml).astype(np.int64)
    je = (j + ml).astype(np.int64)
    base = np.int64(len(arr) - 1)
    active = pe < limit
    s = 16
    while active.any():
        a = np.nonzero(active)[0]
        off = np.arange(s, dtype=np.int64)
        pa = pe[a, None] + off
        ja = je[a, None] + off
        eq = (arr[np.minimum(pa, base)] == arr[np.minimum(ja, base)]) & (pa < limit)
        allm = eq.all(axis=1)
        adv = np.where(allm, s, eq.argmin(axis=1))
        pe[a] += adv
        je[a] += adv
        active[a] = allm & (pe[a] < limit)
        if s < 4096:
            s *= 2
    return pe - p


def resolve_matches_host(arr: np.ndarray, src: np.ndarray, mlen: np.ndarray,
                         n: int, limit: int, capj: int = CAPJ):
    """Greedy-parse the device match tables into final non-overlapping
    sequences with exact lengths, fully vectorized.  Copy of
    ``lz4_jax.resolve_matches_host``.

    Capped lengths (>= ``capj``) are made exact before the parse with the
    same-delta-run identity: within a maximal run of consecutive capped
    positions sharing delta = p - src, L(p) = L(run_end) + (run_end - p), so
    the byte compares run only at run ends.  Returns (positions, sources,
    lengths) int64 arrays, sorted by position."""
    src64 = src.astype(np.int64)
    mlen = mlen.astype(np.int64)
    capped = mlen >= capj
    if capped.any():
        B = len(mlen)
        pos = np.arange(B, dtype=np.int64)
        delta = np.where(mlen >= MIN_MATCH, pos - src64, np.int64(-1))
        nxt_delta = np.concatenate([delta[1:], np.array([-2], np.int64)])
        nxt_capped = np.concatenate([capped[1:], [False]])
        run_end = capped & ((delta != nxt_delta) | ~nxt_capped)
        ends = np.nonzero(run_end)[0]
        l_end = _extend_capped(arr, limit, ends, src64[ends], mlen[ends])
        # nearest run end at/after p: runs are contiguous, so a reverse
        # min-scan of end positions resolves every capped p to its own end
        end_of = np.minimum.accumulate(np.where(run_end, pos, B)[::-1])[::-1]
        l_at_end = np.zeros(B, np.int64)
        l_at_end[ends] = l_end
        exact_l = l_at_end[np.minimum(end_of, B - 1)] + (end_of - pos)
        mlen = np.where(capped, exact_l, mlen)
    match_ev = parse_events_host(src64, mlen, n)
    return match_ev, src64[match_ev], mlen[match_ev]


def from_jax_wire(mode: str, arrays):
    """The JAX tokenizers' device wire formats -> position-ordered
    ``(src int32, -1 = none; mlen int32)`` numpy tables.

    * ``"pair"``: ``(src u16, code u8)`` (``tokenize_block_resort``, and
      this module's :func:`tokenize`);
    * ``"u16"``: one u16 token ``src << 3 | code`` (``tokenize_block_u16``);
    * ``"hash"``: hash-ordered ``(pos, mlen << 17 | src)``
      (``tokenize_blocks_device``, ``tokenize_block_noscatter``; the
      ``unsort_host`` of ``lz4_pallas``)."""
    if mode == "pair":
        return unpack_resort_host(*arrays)
    if mode == "u16":
        (tok,) = arrays
        v = np.asarray(tok).astype(np.int32)
        code = v & 7
        mlen = np.where(code > 0, code + 3, 0).astype(np.int32)
        return np.where(code > 0, v >> 3, -1).astype(np.int32), mlen
    if mode == "hash":
        pos, packed = (np.asarray(a) for a in arrays)
        out = np.empty_like(packed)
        np.put_along_axis(out, pos.astype(np.int64), packed, axis=-1)
        mlen = (out >> 17).astype(np.int32)
        src = np.where(mlen == 0, -1, out & 0x1FFFF).astype(np.int32)
        return src, mlen
    raise ValueError(f"unknown wire mode {mode!r}")


def serialize_block_host(data: bytes, src: np.ndarray, mlen: np.ndarray,
                         capj: int = 16) -> bytes:
    """Assemble the LZ4 block from the device match tables: vectorized
    fixpoint parse and extension (:func:`resolve_matches_host`), then
    vectorized byte serialization.  Copy of ``lz4_jax.serialize_block_host``."""
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    mps, mss, mls = resolve_matches_host(arr, src, mlen, n, n - LAST_LITERALS, capj)
    return lz4block.serialize_sequences_np(data, mps, mss, mls)


def compress_block(data: bytes, device, depth: int = 2, n_words: int = 2) -> bytes:
    """One LZ4 block, matcher on ``device``, parse and serialization on the
    host: the twin of ``lz4_jax.compress_block_tpu``, with the same bytes.
    The input is zero-padded to a multiple of 128 and at least 256 bytes and
    tokenized in the "hash" wire format at cap ``4 * n_words``; inputs under
    13 bytes go to the host encoder."""
    n = len(data)
    if n < MFLIMIT + 1:
        return lz4block.compress_block(data)
    B = max(256, -(-n // 128) * 128)
    padded = np.zeros((1, B), dtype=np.uint8)
    padded[0, :n] = np.frombuffer(data, dtype=np.uint8)
    wire = tokenize(torch.from_numpy(padded).to(device), depth, 4 * n_words, mode="hash")
    src, mlen = from_jax_wire("hash", [t[0].cpu().numpy() for t in wire])
    if n != B:
        # padding may have created or extended matches past n: re-clamp
        posa = np.arange(B)
        mlen = np.minimum(mlen, np.maximum(n - LAST_LITERALS - posa, 0))
        mlen = np.where(posa >= max(n - MFLIMIT, 0), 0, mlen)
        mlen = np.where(mlen < MIN_MATCH, 0, mlen)
    return serialize_block_host(data, src, mlen, 4 * n_words)


def entry(device):
    """``(forward, (sample,))``: the twin of ``__graft_entry__.entry()``, the
    forward step of the flagship compute path on ``device``.  ``forward``
    tokenizes one block (a 1-D uint8 tensor) at depth 2 and cap 16 and
    returns the position-ordered ``(src int32, -1 = none; mlen int32)`` of
    ``lz4_jax.tokenize_block``; ``sample`` is the same seeded 16 KiB block."""

    def forward(data: torch.Tensor):
        src, mlen = tokenize(data[None, :], 2, 16, mode="scatter")
        return src[0], mlen[0]

    rng = np.random.default_rng(0)
    sample = np.where(
        rng.random(16384) < 0.7,
        np.tile(np.frombuffer(b"zpack tpu sample", dtype=np.uint8), 1024),
        rng.integers(0, 256, 16384),
    ).astype(np.uint8)
    return forward, (torch.from_numpy(sample).to(device),)


# ---------------------------------------------------------------------------
# Block serializer
# ---------------------------------------------------------------------------

#: the wire formats the serializer takes, in the order of the kernel's mode
#: argument (the tokenizer's, without a dictionary)
SERIALIZE_MODES = ("pair", "u16")
#: bytes before the sections in a :func:`serialize_sections` buffer: their
#: total and the count of blocks that overflowed, an int64 each
SERIALIZE_HEADER = 16

#: the parses the serializer takes, in the order of the kernel's argument:
#: LZ4's fast levels' greedy parse, and its high-compression levels' lazy one
PARSES = ("greedy", "hc")
#: the HC parse weighs a literal step only at a match shorter than this,
#: which the kernel's scan settles exactly (its kMinMatch + kScanExtend)
HC_LAZY_CAP = 36
#: the kernel name a serializer launch is recorded under, by its parse
SERIALIZE_KEYS = ("lz4_serialize", "lz4_serialize_hc")

_OVERFLOW = ("lz4_serialize: {} block(s) overflowed the serializer's output bound "
             "(match tables the tokenizer did not write)")


def _lsic_len(v: int) -> int:
    """Bytes that extend a length nibble for a length ``v`` (none under 15)."""
    return (v - 15) // 255 + 1 if v >= 15 else 0


def _lsic(v: int) -> bytes:
    return b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255]) if v >= 15 else b""


def _forward(d: np.ndarray, p: int, j: int, e: int, limit: int) -> int:
    """``e`` grown while ``p + e < limit`` and ``d[p + e] == d[j + e]``."""
    step = 16
    while p + e < limit:
        k = min(step, limit - p - e)
        diff = np.flatnonzero(d[p + e:p + e + k] != d[j + e:j + e + k])
        if len(diff):
            return e + int(diff[0])
        e += k
        step *= 2
    return e


def _serialize_block_plain(d: np.ndarray, src: np.ndarray, mlen: np.ndarray, cl: int,
                           parse: str = "greedy"):
    """``(section, overflowed)`` of one block of ``cl`` true bytes, in the
    phases of ``csrc/lz4_serialize.cu``."""
    limit = max(cl - LAST_LITERALS, 0)
    mflim = max(cl - MFLIMIT, 0)
    pos = np.arange(len(mlen))
    accepted = ((mlen >= MIN_MATCH) & (src >= 0) & (src < pos) & (pos - src <= 65535)
                & (pos >= 1) & (pos < mflim))
    cand = np.flatnonzero(accepted).tolist()

    def forward(q: int) -> int:
        """F(q): the match clipped to limit and extended while bytes agree,
        0 where q is rejected or that length is under 4."""
        if q >= len(accepted) or not accepted[q]:
            return 0
        f = _forward(d, q, int(src[q]), min(int(mlen[q]), limit - q), limit)
        return f if f >= MIN_MATCH else 0

    # 1. the chain: from p, the next accepted q and its forward length F(q);
    #    then p = q + F(q), which backward extension never moves.  The HC
    #    parse first weighs a literal step: at F(q) < HC_LAZY_CAP it moves
    #    to q + 1 where F(q + 1) > F(q) or F(q + 2) > F(q) + 1
    chain = []
    p, i = 1, 0
    while True:
        i = bisect.bisect_left(cand, p, i)
        if i == len(cand):
            break
        q = cand[i]
        f = forward(q)
        if f == 0:
            p = q + 1
            continue
        if parse == "hc" and f < HC_LAZY_CAP and (forward(q + 1) > f
                                                  or forward(q + 2) > f + 1):
            p = q + 1
            continue
        chain.append((q, int(src[q]), f))
        p = q + f
    # 2. backward extension of each sequence, down to the previous one's end
    seqs = []  # (literal start, literal length, offset, match length)
    end = 0
    for q, j, f in chain:
        pp, jj = q, j
        while pp > end and jj > 0 and d[pp - 1] == d[jj - 1]:
            pp -= 1
            jj -= 1
        seqs.append((end, pp - end, q - j, f + q - pp))
        end = q + f
    # 3. each sequence's bytes and their scan; the host serializer's bound
    #    on its output buffer (a conservative need before each emission)
    room = cl + cl // 255 + 16
    sizes = [1 + _lsic_len(ll) + ll + 2 + _lsic_len(ml - MIN_MATCH) for _, ll, _, ml in seqs]
    starts = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).tolist()
    over = any(o + 1 + ll // 255 + 1 + ll + 2 + ml // 255 + 1 > room
               for o, (_, ll, _, ml) in zip(starts, seqs))
    ll_last = cl - end
    over |= starts[-1] + 1 + ll_last // 255 + 1 + ll_last > room
    csz = starts[-1] + 1 + _lsic_len(ll_last) + ll_last
    # 4. the raw-or-compressed choice, then the bytes
    if csz >= cl:
        return struct.pack("<I", cl | 0x80000000) + d[:cl].tobytes(), over
    body = bytearray(struct.pack("<I", csz))
    for lit, ll, off, ml in seqs:
        body.append((min(ll, 15) << 4) | min(ml - MIN_MATCH, 15))
        body += _lsic(ll) + d[lit:lit + ll].tobytes() + struct.pack("<H", off)
        body += _lsic(ml - MIN_MATCH)
    body.append(min(ll_last, 15) << 4)
    body += _lsic(ll_last) + d[end:cl].tobytes()
    return bytes(body), over


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _serialize_rows(blocks, arrays, mode: str, n: int, parse: str = "greedy"):
    """``(sections, blocks that overflowed)`` of the plain version."""
    rows = _host(blocks)
    src, mlen = from_jax_wire(mode, [_host(a) for a in arrays])
    B = rows.shape[1]
    parts, over = [], 0
    for i in range(rows.shape[0]):
        cl = min(B, n - i * B)
        if cl <= 0:
            break
        section, o = _serialize_block_plain(rows[i], src[i], mlen[i], cl, parse)
        parts.append(section)
        over += o
    return b"".join(parts), over


def serialize_plain(blocks, arrays, mode: str, n: int, parse: str = "greedy") -> bytes:
    """The lz4f block sections of a shard, in plain NumPy: the contract of
    ``csrc/lz4_serialize.cu`` and the bytes of
    ``native.lz4_serialize_blocks_packed(data[:n], mode, arrays, B)`` (the
    greedy parse) and ``native.lz4_serialize_blocks_hc`` (the HC parse).

    ``blocks`` (nb, B) uint8, the shard's blocks zero-padded, of which the
    first ``n`` bytes are data; ``arrays`` the tokenizer's wire arrays in
    ``mode`` ("pair" or "u16").  Each block of true length ``cl`` is parsed
    from position 1 below ``cl - 12``: a candidate is accepted where its
    length is 4 or more, its source lies before it and at most 65,535 back,
    and its forward length F, the length clipped to ``cl - 5`` and extended
    while bytes agree, is still 4 or more.  ``parse`` "greedy" (LZ4's fast
    levels, 1 and 2) takes every accepted match; "hc" (its high-compression
    levels, 3 and up) emits an accepted q of F(q) < :data:`HC_LAZY_CAP` as
    a literal where F(q + 1) > F(q) or F(q + 2) > F(q) + 1 (F 0 at a
    rejected position) and takes the others.  A match taken at q ends at q
    + F(q), and extends backward down to the previous sequence's end.  Each
    section is a 4-byte size (the high bit for a block stored raw, which it
    is where the compressed bytes would be ``cl`` or more) and the payload.
    Raises where a block overflows the host serializer's output bound, as
    that serializer fails."""
    body, over = _serialize_rows(blocks, arrays, mode, n, parse)
    if over:
        raise RuntimeError(_OVERFLOW.format(over))
    return body


def serialize_sections(blocks: torch.Tensor, arrays, mode: str, n: int,
                       parse: str = "greedy") -> torch.Tensor:
    """The block sections of a shard serialized where its tables are, for
    one read-back.  Returns a uint8 tensor on the device of ``blocks`` of
    ``SERIALIZE_HEADER + n + 4 * nb`` bytes: the sections' total and the
    count of blocks that overflowed (an int64 each), then the sections of
    :func:`serialize_plain` back to back, in ``parse``.  The plain version
    on the CPU; on a GPU one call of ``csrc/lz4_serialize.cu`` (its walk and
    its placement kernels), enqueued on the current stream and not waited
    for; an HC launch is recorded as ``lz4_serialize_hc``."""
    if mode not in SERIALIZE_MODES:
        raise ValueError(f"the serializer takes the 'pair' and 'u16' wire modes, not {mode!r}")
    if parse not in PARSES:
        raise ValueError(f"the serializer's parses are {PARSES}, not {parse!r}")
    k = PARSES.index(parse)
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError("blocks must be a (nb, B) uint8 tensor")
    nb, B = blocks.shape
    if not 0 <= n <= nb * B:
        raise ValueError(f"{n} data bytes do not fit {nb} blocks of {B}")
    if mode == "u16" and B > 8192:
        raise ValueError(f"mode 'u16' packs src into 13 bits: block {B} > 8192")
    size = SERIALIZE_HEADER + n + 4 * nb
    if blocks.device.type == "cpu":
        body, over = _serialize_rows(blocks, arrays, mode, n, parse)
        out = torch.zeros(size, dtype=torch.uint8)
        head = torch.tensor([len(body), over], dtype=torch.int64)
        out[:SERIALIZE_HEADER] = head.view(torch.uint8)
        out[SERIALIZE_HEADER:SERIALIZE_HEADER + len(body)] = torch.from_numpy(
            np.frombuffer(body, dtype=np.uint8).copy())
        return out
    dev = blocks.device
    if dev.type != "cuda" or not blocks.is_contiguous():
        raise ValueError("serialize takes a contiguous CPU or CUDA tensor")
    if (len(arrays) != len(WIRE_DTYPES[mode])
            or any(a.dtype != t or a.shape != (nb, B) or a.device != dev or not a.is_contiguous()
                   for a, t in zip(arrays, WIRE_DTYPES[mode]))):
        raise ValueError(f"the {mode!r} wire arrays must be contiguous ({nb}, {B}) tensors of "
                         f"{WIRE_DTYPES[mode]} beside the blocks")
    out = torch.empty(size, dtype=torch.uint8, device=dev)
    if nb == 0:
        return out.zero_()
    slot = -(-(4 + B + B // 255 + 16) // 16) * 16
    # the chain in order, then 32 segments' walks and their joins
    # (``chain_words`` in the source: a segment of at least 64 positions
    # records at most a step in 4)
    seg_cap = max(64, -(-B // 32)) // 4 + 2
    chain = torch.empty((nb, B // 4 + 2 + 64 * seg_cap), dtype=torch.int32, device=dev)
    slots = torch.empty((nb, slot), dtype=torch.uint8, device=dev)
    sizes = torch.empty(nb, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().zp_lz4_serialize(
            blocks.data_ptr(), nb, B, n, SERIALIZE_MODES.index(mode), k,
            arrays[0].data_ptr(), arrays[1].data_ptr() if len(arrays) > 1 else None,
            chain.data_ptr(), chain.shape[1], slots.data_ptr(), slot, sizes.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lz4_serialize")
    launched(SERIALIZE_KEYS[k])
    return out


def sections(buf) -> memoryview:
    """The sections of a :func:`serialize_sections` buffer on the host (a
    numpy array or a CPU tensor), without a copy; raises where a block
    overflowed."""
    a = _host(buf)
    total, over = (int(v) for v in a[:SERIALIZE_HEADER].view(np.int64))
    if over:
        raise RuntimeError(_OVERFLOW.format(over))
    return memoryview(a[SERIALIZE_HEADER:SERIALIZE_HEADER + total])


# ---------------------------------------------------------------------------
# Sequence replay
# ---------------------------------------------------------------------------

#: output / literal buckets and sequence-count buckets of the replay batch
#: (the JAX replayer's, so both packages batch the same shapes)
BUCKETS = (1024, 4096, 16384, 65536)
SEQ_BUCKETS = (64, 256, 1024, 4096, 16384)


def parse_block_sequences(data: bytes):
    """Token-walk one LZ4 block WITHOUT executing it: returns
    (lit_lens, offsets, match_lens) int32 arrays + the concatenated literal
    bytes.  The final literal-only run appears with offset 0 / match_len 0.

    Copy of ``lz4_jax.parse_block_sequences`` that also rejects a match
    offset reaching before the block start, as the host decoder does
    (``codecs/lz4/block.py``), so no such offset ever reaches the device."""
    src = bytes(data)
    n = len(src)
    pos = 0
    out_len = 0
    lit_lens, offsets, match_lens = [], [], []
    lits = bytearray()
    while pos < n:
        token = src[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated literal length")
                c = src[pos]
                pos += 1
                lit_len += c
                if c != 255:
                    break
        if pos + lit_len > n:
            raise DecompressError("literal run overruns input")
        lits += src[pos : pos + lit_len]
        pos += lit_len
        out_len += lit_len
        if pos == n:
            lit_lens.append(lit_len)
            offsets.append(0)
            match_lens.append(0)
            break
        if pos + 2 > n:
            raise DecompressError("truncated match offset")
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0:
            raise DecompressError("zero match offset")
        if offset > out_len:
            raise DecompressError("match offset beyond output start")
        match_len = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                if pos >= n:
                    raise DecompressError("truncated match length")
                c = src[pos]
                pos += 1
                match_len += c
                if c != 255:
                    break
        out_len += match_len
        lit_lens.append(lit_len)
        offsets.append(offset)
        match_lens.append(match_len)
    return (np.array(lit_lens, np.int32), np.array(offsets, np.int32),
            np.array(match_lens, np.int32), bytes(lits))


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def build_batch(blocks: list[bytes], out_sizes: list[int]):
    """Parse independent LZ4 blocks into the padded replay batch of the JAX
    replayer (``DeviceLZ4Replayer.decompress_blocks``): a dict of numpy
    arrays ``lit_bytes (Bp, L) u8``, ``seg_start/lit_start/lit_len/offset
    (Bp, S) i32``, ``n_seq (Bp,)`` and ``out_len (Bp,)`` (each row's decoded
    size; 0 for padding rows), plus ``n_out``.  Raises DecompressError for a
    malformed block or one that decodes past its declared size."""
    parsed = [parse_block_sequences(b) for b in blocks]
    bp = 8
    while bp < len(blocks):
        bp <<= 1
    S = _bucket(max(len(p[0]) for p in parsed), SEQ_BUCKETS)
    L = _bucket(max(len(p[3]) for p in parsed), BUCKETS)
    batch = {
        "lit_bytes": np.zeros((bp, L), np.uint8),
        "seg_start": np.zeros((bp, S), np.int32),
        "lit_start": np.zeros((bp, S), np.int32),
        "lit_len": np.zeros((bp, S), np.int32),
        "offset": np.zeros((bp, S), np.int32),
        "n_seq": np.zeros(bp, np.int32),
        "out_len": np.zeros(bp, np.int32),
    }
    for i, (lls, offs, mls, lits) in enumerate(parsed):
        k = len(lls)
        seg_len = lls + mls
        total = int(seg_len.sum())
        if total > out_sizes[i]:
            raise DecompressError("block output exceeds declared size")
        batch["seg_start"][i, :k] = np.cumsum(seg_len) - seg_len
        batch["lit_start"][i, :k] = np.cumsum(lls) - lls
        batch["lit_len"][i, :k] = lls
        batch["offset"][i, :k] = offs
        batch["n_seq"][i] = k
        batch["out_len"][i] = total
        batch["lit_bytes"][i, : len(lits)] = np.frombuffer(lits, np.uint8)
    batch["n_out"] = _bucket(max(int(batch["out_len"].max()), 1), BUCKETS)
    return batch


#: the replay's tensor arguments, in order (keys of :func:`build_batch`)
REPLAY_ARGS = ("lit_bytes", "seg_start", "lit_start", "lit_len", "offset",
               "n_seq", "out_len")


#: the messages of :func:`parse_block_sequences`, in the order of the CUDA
#: parse's error codes 1..6 (``csrc/lz4_parse.cu``)
PARSE_ERRORS = ("truncated literal length", "literal run overruns input",
                "truncated match offset", "zero match offset",
                "match offset beyond output start", "truncated match length")
#: the longest row (compressed bytes) the CUDA parse stages in shared
#: memory, every block of lz4f's 64 KiB size; a longer one is read from
#: global memory
PARSE_STAGE_CAP = 64 << 10
#: rows must be shorter than this, so that every length fits in int32
PARSE_MAX_ROW = 1 << 23
#: the rows a CTA of the CUDA walk may hold (one walker warp each, 8 warps),
#: the groupings :func:`parse_plan` chooses from
PARSE_GROUPS = (1, 2, 4, 8)
#: stage bytes past a CTA's last row: the walker reads a token ahead
PARSE_AHEAD = 32
#: the stage a walk CTA may take: 227 KiB, less 1 KiB for its static part
PARSE_SMEM_MAX = 232448 - 1024


def seq_bound(n: int) -> int:
    """The most sequences a block of ``n`` compressed bytes can hold: each
    but the last takes a token and a 2-byte offset, the last a token."""
    return (n - 1) // 3 + 1 if n > 0 else 0


def _places(lens: np.ndarray) -> np.ndarray:
    """Each row's place in a walk CTA's stage: ``16 * ((n + 30) // 16)``
    bytes (its 16-byte chunks at any alignment), none for an empty row or
    one above :data:`PARSE_STAGE_CAP` (read from global memory)."""
    return np.where((lens > 0) & (lens <= PARSE_STAGE_CAP), 16 * ((lens + 30) // 16), 0)


def _deal(sorted_rows: np.ndarray, group: int, fill) -> np.ndarray:
    """The rows, sorted by size, dealt to ``ceil(B / group)`` CTAs in a snake
    (down the CTAs, then back up): ``(G, group)``, ``fill`` past the last."""
    G = -(-len(sorted_rows) // group)
    deal = np.full(G * group, fill, sorted_rows.dtype)
    deal[:len(sorted_rows)] = sorted_rows
    deal = deal.reshape(group, G)
    deal[1::2] = deal[1::2, ::-1]
    return deal.T


def _pack(order: np.ndarray, places: np.ndarray, group: int):
    """The rows in ``order`` (largest first) dealt to CTAs of ``group``
    (:func:`_deal`), so the CTAs' stages come out near the mean, with their
    ``places`` in that order.  Returns ``slots (G, group, 2)`` int64, each
    CTA's rows (-1: none) and their offsets in its stage (-1: no place),
    and the stage bytes a CTA needs (the largest CTA's, plus
    :data:`PARSE_AHEAD`)."""
    rows = _deal(order, group, -1)
    place = _deal(places, group, 0)
    slots = np.empty(rows.shape + (2,), np.int64)
    slots[..., 0] = rows
    slots[..., 1] = np.where(place > 0, np.cumsum(place, axis=1) - place, -1)
    return slots, int(place.sum(1).max()) + PARSE_AHEAD


def parse_plan(lens, ctas_per_sm, sms: int) -> dict:
    """The CUDA walk's launch: the rows packed into CTAs by size, largest
    beside smallest, in the grouping of :data:`PARSE_GROUPS` whose CTAs run
    in the fewest waves on ``sms`` SMs (the smaller group on a tie);
    ``ctas_per_sm(smem)`` is the walk's CTAs an SM holds with that stage.
    Returns ``slots (G, group, 2)`` and ``smem`` (:func:`_pack`),
    ``group``, ``ctas``, ``per_sm``, ``waves`` and ``resident``, the
    walkers the first wave holds."""
    lens = np.asarray(lens, np.int64)
    order = np.argsort(-lens, kind="stable")
    places = _places(lens)[order]
    best = None
    for g in PARSE_GROUPS:
        smem = int(_deal(places, g, 0).sum(1).max()) + PARSE_AHEAD
        per_sm = ctas_per_sm(smem) if smem <= PARSE_SMEM_MAX else 0
        if per_sm < 1:
            continue
        ctas = -(-len(lens) // g)
        waves = -(-ctas // (per_sm * sms))
        if best is None or waves < best["waves"]:
            best = {"group": g, "ctas": ctas, "per_sm": per_sm, "waves": waves}
        if waves == 1:
            break
    if best is None:
        raise ValueError(f"no grouping of {PARSE_GROUPS} rows a CTA fits the shared memory")
    slots, smem = _pack(order, places, best["group"])
    first = slots[:best["per_sm"] * sms, :, 0]
    return {**best, "slots": slots, "smem": smem,
            "resident": int(np.count_nonzero(first >= 0))}


def pack_blocks(blocks: list[bytes], pin: bool = False):
    """The blocks back to back in one uint8 tensor (pinned if ``pin``), and
    their ``(B + 1,)`` int64 offsets."""
    offsets = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([len(b) for b in blocks], out=offsets[1:])
    flat = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=pin)
    view = flat.numpy()
    for b, lo, hi in zip(blocks, offsets[:-1], offsets[1:]):
        view[lo:hi] = np.frombuffer(b, np.uint8)
    return flat, offsets


def _batch_shape(n_seq, lit_total, out_len):
    """``(Bp, S, L, n_out)`` of :func:`build_batch` from the rows' totals."""
    bp = 8
    while bp < len(n_seq):
        bp <<= 1
    return (bp, _bucket(int(max(n_seq)), SEQ_BUCKETS), _bucket(int(max(lit_total)), BUCKETS),
            _bucket(max(int(max(out_len)), 1), BUCKETS))


_WALK_CTAS: dict = {}  # (device index, stage bytes) -> the walk's CTAs an SM


def walk_ctas_per_sm(smem: int, dev: torch.device) -> int:
    """The CUDA walk's CTAs that one SM of ``dev`` holds with ``smem``
    bytes of stage (the CUDA occupancy query, cached)."""
    key = (dev.index, smem)
    if key not in _WALK_CTAS:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check(_build.lib().zp_lz4_parse_occupancy(smem, ctypes.byref(out)),
                         "lz4_parse")
        _WALK_CTAS[key] = out.value
    return _WALK_CTAS[key]


def _parse_walk(payload: torch.Tensor, offsets: np.ndarray) -> dict:
    """Launch pass 1 of the CUDA parse (both steps): the rows ``(B, 2)``
    int64, each row's first slot, the launch's :func:`parse_plan`, the
    scratch (token positions, each row's chain result), the records and
    ``info (B, 4)`` int32 ``(n_seq, literal total, out_len, error code)``,
    all on the card."""
    dev = payload.device
    B = len(offsets) - 1
    lens = np.diff(offsets)
    if (lens < 0).any() or offsets[0] < 0 or offsets[-1] > payload.numel():
        raise ValueError("block offsets outside the payload")
    if lens.max() >= PARSE_MAX_ROW:
        raise ValueError(f"a block of {int(lens.max())} bytes: the parse takes rows under "
                         f"{PARSE_MAX_ROW}")
    plan = parse_plan(lens, lambda smem: walk_ctas_per_sm(smem, dev),
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    # the rows, each row's first slot and the CTAs' slots, in one upload
    meta = np.empty(3 * B + plan["slots"].size, np.int64)
    meta[0:2 * B:2], meta[1:2 * B:2] = offsets[:-1], lens
    bounds = np.where(lens > 0, (lens - 1) // 3 + 1, 0)
    meta[2 * B] = 0
    np.cumsum(bounds[:-1], out=meta[2 * B + 1:3 * B])
    meta[3 * B:] = plan["slots"].ravel()
    with metrics.phase("torch.lz4_parse.wait"):  # a blocking upload
        meta = torch.from_numpy(meta).to(dev)
    n_slots = max(int(bounds.sum()), 1)
    w = {"rows": meta[:2 * B], "rec_off": meta[2 * B:3 * B], "slots": meta[3 * B:],
         "plan": plan,
         "tpos": torch.empty(n_slots, dtype=torch.int32, device=dev),
         "chain": torch.empty((B, 2), dtype=torch.int32, device=dev),
         "rec": torch.empty((n_slots, 4), dtype=torch.int32, device=dev),
         "info": torch.empty((B, 4), dtype=torch.int32, device=dev)}
    _walk_launch(payload, w, 3)
    return w


def _walk_launch(payload: torch.Tensor, w: dict, steps: int) -> None:
    """The walk kernel on :func:`_parse_walk`'s tensors: ``steps`` 1 the
    chain alone, 2 the values alone (from the chain's scratch), 3 both."""
    plan = w["plan"]
    dev = payload.device
    with torch.cuda.device(dev):
        rc = _build.lib().zp_lz4_parse_walk(
            payload.data_ptr(), w["rows"].data_ptr(), w["rec_off"].data_ptr(),
            w["slots"].data_ptr(), plan["ctas"], plan["group"], plan["smem"], steps,
            w["tpos"].data_ptr(), w["chain"].data_ptr(), w["rec"].data_ptr(),
            w["info"].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lz4_parse")


def _parse_layout(payload: torch.Tensor, w: dict, bp: int, S: int, L: int) -> dict:
    """Launch pass 2 of the CUDA parse: the replay's tables from the walk's
    records, every lane written."""
    dev = payload.device
    out = {"lit_bytes": torch.empty((bp, L), dtype=torch.uint8, device=dev),
           **{k: torch.empty((bp, S), dtype=torch.int32, device=dev)
              for k in ("seg_start", "lit_start", "lit_len", "offset")},
           "n_seq": torch.empty(bp, dtype=torch.int32, device=dev),
           "out_len": torch.empty(bp, dtype=torch.int32, device=dev)}
    with torch.cuda.device(dev):
        rc = _build.lib().zp_lz4_parse_layout(
            payload.data_ptr(), w["rows"].data_ptr(), w["rec_off"].data_ptr(),
            w["rec"].data_ptr(), w["info"].data_ptr(), len(w["info"]), bp, S, L,
            *(out[k].data_ptr() for k in REPLAY_ARGS), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lz4_parse")
    return out


def parse_batch(payload: torch.Tensor, offsets, out_sizes) -> dict:
    """:func:`build_batch` of the blocks ``payload[offsets[i]:offsets[i + 1]]``
    as tensors on ``payload``'s device: on the CPU, the host parse; on a GPU,
    the CUDA parse (``csrc/lz4_parse.cu``: each block's token chain and
    its values, one small read-back of each row's totals, then the tables
    laid out by scans).
    Same tables, same errors, in the same order: the first block's parse
    error, then the first block over its declared size.  The dict also
    holds ``n_out`` and, as numpy, ``out_len_host`` (the B blocks' rows).
    Rows of 2^23 bytes or more raise ValueError on a GPU."""
    offsets = np.asarray(offsets, np.int64)
    if len(offsets) < 2 or payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("parse_batch takes a 1-D uint8 payload and at least one block")
    if payload.device.type == "cpu":
        flat = payload.numpy().tobytes()
        batch = build_batch([flat[a:b] for a, b in zip(offsets[:-1], offsets[1:])], out_sizes)
        out = {k: torch.from_numpy(batch[k]) for k in REPLAY_ARGS}
        return {**out, "n_out": batch["n_out"],
                "out_len_host": batch["out_len"][:len(offsets) - 1]}
    if payload.device.type != "cuda" or not payload.is_contiguous():
        raise ValueError("parse_batch takes a contiguous CPU or CUDA tensor")
    w = _parse_walk(payload, offsets)
    with metrics.phase("torch.lz4_parse.wait", w["info"].nbytes):
        n_seq, lit_total, out_len, err = w["info"].cpu().numpy().T
    bad = np.flatnonzero(err)
    if bad.size:
        raise DecompressError(PARSE_ERRORS[int(err[bad[0]]) - 1])
    if (out_len > np.asarray(out_sizes, np.int64)).any():
        raise DecompressError("block output exceeds declared size")
    bp, S, L, n_out = _batch_shape(n_seq, lit_total, out_len)
    out = _parse_layout(payload, w, bp, S, L)
    launched("lz4_parse")
    return {**out, "n_out": n_out, "out_len_host": out_len}


def replay_plain(lit_bytes, seg_start, lit_start, lit_len, offset, n_seq,
                 out_len, *, n_out: int) -> torch.Tensor:
    """Batched sequence replay in plain PyTorch: the ``_replay_build`` +
    pointer doubling + ``_replay_emit`` recipe of ``lz4_jax``.

    Every output position maps to its sequence (scatter + cumsum), a
    literal position to its literal byte, a match position ``offset``
    bytes back with self-overlapping matches folded to their first period;
    pointer doubling then resolves copy chains to literal positions.
    Padding lanes (sequences past ``n_seq``, positions past ``out_len``)
    are masked explicitly.  Returns (Bp, n_out) uint8, zero past each
    row's ``out_len``."""
    bp, S = seg_start.shape
    dev = seg_start.device
    i64 = torch.int64
    seg_start, lit_start, lit_len, offset = (
        t.to(i64) for t in (seg_start, lit_start, lit_len, offset))
    sidx = torch.arange(S, device=dev)
    marks = torch.where((sidx >= 1) & (sidx < n_seq.to(i64)[:, None]),
                        seg_start, n_out)
    hits = torch.zeros((bp, n_out + 1), dtype=i64, device=dev)
    hits.scatter_add_(1, marks.clamp(0, n_out), torch.ones_like(marks))
    seg_of = hits[:, :n_out].cumsum(1).clamp(max=S - 1)
    pos = torch.arange(n_out, device=dev, dtype=i64).expand(bp, n_out)
    st = seg_start.gather(1, seg_of)
    ll = lit_len.gather(1, seg_of)
    inlit = (pos - st) < ll
    lit_idx = (lit_start.gather(1, seg_of) + (pos - st)).clamp(0, lit_bytes.shape[1] - 1)
    m0 = st + ll
    off = offset.gather(1, seg_of).clamp(min=1)
    valid = pos < out_len.to(i64)[:, None]
    f = torch.where(inlit | ~valid, pos, m0 - off + (pos - m0) % off).clamp(min=0)
    while True:
        f2 = f.gather(1, f)
        if torch.equal(f2, f):
            break
        f = f2
    out = lit_bytes.gather(1, lit_idx.gather(1, f))
    return torch.where(valid, out, 0).to(torch.uint8)


#: positions a tile of the CUDA replay, and the ints of its zeroed state: the
#: error word, then a flag a round (``kTile``, ``kState`` in ``csrc/lz4_replay.cu``)
REPLAY_TILE = 1024
REPLAY_STATE = 40


#: what :func:`replay` raises when the kernels leave a position unresolved
REPLAY_UNRESOLVED = ("lz4_replay: a copy chain was left unresolved; the sequence tables are "
                     "inconsistent and the output is incomplete")


def replay(lit_bytes, seg_start, lit_start, lit_len, offset, n_seq, out_len,
           *, n_out: int) -> torch.Tensor:
    """:func:`replay_plain` on the CPU; on a GPU, the CUDA sequence replay
    (``csrc/lz4_replay.cu``).  Same inputs, same outputs.

    The kernels take one int32 of scratch per output byte.  They set an
    error word if a position is left unresolved, and this function raises on
    it (it reads the word back, so it returns after the launches have
    finished)."""
    args = (lit_bytes, seg_start, lit_start, lit_len, offset, n_seq, out_len)
    if lit_bytes.device.type == "cpu":
        return replay_plain(*args, n_out=n_out)
    out, state = replay_enqueue(*args, n_out=n_out)
    if state is not None:
        with metrics.phase("torch.replay.wait", 4):
            failed = int(state[0])
        if failed:
            raise RuntimeError(REPLAY_UNRESOLVED)
    return out


def replay_enqueue(lit_bytes, seg_start, lit_start, lit_len, offset, n_seq, out_len,
                   *, n_out: int):
    """:func:`replay` without its read-back: returns ``(out, state)``, the
    rows and the kernels' state, whose word 0 is the error word (nonzero:
    a position left unresolved), unread; ``state`` is None where nothing
    was launched.  On the CPU, :func:`replay_plain` and a zero state."""
    args = (lit_bytes, seg_start, lit_start, lit_len, offset, n_seq, out_len)
    if lit_bytes.device.type == "cpu":
        return replay_plain(*args, n_out=n_out), torch.zeros(REPLAY_STATE, dtype=torch.int32)
    if lit_bytes.device.type != "cuda":
        raise ValueError("replay takes CPU or CUDA tensors")
    bp, S = seg_start.shape
    for name, t in zip(REPLAY_ARGS, args):
        if t.device != lit_bytes.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {lit_bytes.device}")
        want = torch.uint8 if name == "lit_bytes" else torch.int32
        if t.dtype != want or t.shape[0] != bp:
            raise ValueError(f"{name} must be {want} with {bp} rows")
    for t in (lit_start, lit_len, offset):
        if t.shape != seg_start.shape:
            raise ValueError("sequence tables must share one (Bp, S) shape")
    dev = lit_bytes.device
    out = torch.empty((bp, n_out), dtype=torch.uint8, device=dev)
    if bp == 0 or n_out == 0:
        return out, None
    fstride = -(-n_out // 4) * 4
    tiles = bp * -(-fstride // REPLAY_TILE)
    if tiles >= 2**31 or fstride >= 2**31:
        raise ValueError("too many bytes for one replay launch")
    # one pointer per output byte; the tile flags (all live); the state
    f = torch.empty((bp, fstride), dtype=torch.int32, device=dev)
    live = torch.ones(tiles, dtype=torch.int32, device=dev)
    state = torch.zeros(REPLAY_STATE, dtype=torch.int32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.zp_lz4_replay(
            lit_bytes.data_ptr(), lit_bytes.shape[1], seg_start.data_ptr(),
            lit_start.data_ptr(), lit_len.data_ptr(), offset.data_ptr(),
            n_seq.data_ptr(), out_len.data_ptr(), bp, S, n_out, out.data_ptr(),
            f.data_ptr(), fstride, live.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lz4_replay")
    launched("lz4_replay")
    return out, state


class DeviceLZ4Replayer:
    """Parse blocks' token streams and replay the sequences on ``device``,
    trim the outputs (bit-exact vs ``block.decompress_block`` for
    independent blocks).  On the CPU: :func:`build_batch` and
    :func:`replay_plain`.  On a GPU: the blocks go up once from pinned
    memory, the CUDA parse builds the replay's tables there
    (:func:`parse_batch`), the replay runs, the rows are trimmed to their
    lengths on the card and come back in one copy to pinned memory."""

    def __init__(self, device):
        self.device = torch.device(device)

    def decompress_blocks(self, blocks: list[bytes], out_sizes: list[int]) -> list[bytes]:
        """blocks: independent LZ4 block payloads; out_sizes: their declared
        decoded-size bounds.  Returns the decoded bytes."""
        if not blocks:
            return []
        if self.device.type == "cpu":
            batch = build_batch(blocks, out_sizes)
            out = replay_plain(*(torch.from_numpy(batch[k]) for k in REPLAY_ARGS),
                               n_out=batch["n_out"]).numpy()
            return [out[i, : batch["out_len"][i]].tobytes() for i in range(len(blocks))]
        with metrics.phase("torch.lz4_pack", sum(map(len, blocks))):
            flat, offsets = pack_blocks(blocks, pin=True)
            payload = flat.to(self.device, non_blocking=True)
        with metrics.phase("torch.lz4_parse", len(flat)):
            batch = parse_batch(payload, offsets, out_sizes)
        lens = batch["out_len_host"].astype(np.int64)
        with metrics.phase("torch.replay", int(lens.sum())):
            out = replay(*(batch[k] for k in REPLAY_ARGS), n_out=batch["n_out"])
        with metrics.phase("torch.lz4_trim", int(lens.sum())):
            keep = torch.arange(batch["n_out"], device=self.device) < \
                batch["out_len"][:len(blocks), None]
            host = torch.empty(int(lens.sum()), dtype=torch.uint8, pin_memory=True)
            with metrics.phase("torch.lz4_trim.wait", host.nbytes):
                host.copy_(out[:len(blocks)].masked_select(keep))
            view = host.numpy()
            ends = np.cumsum(lens)
            return [view[e - n:e].tobytes() for e, n in zip(ends.tolist(), lens.tolist())]
