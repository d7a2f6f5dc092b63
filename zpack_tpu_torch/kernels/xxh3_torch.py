"""Batched and single-stream XXH3-64 for PyTorch.

Counterpart of ``zpack_tpu/kernels/xxh3_pallas.py`` (many streams, one per
TPU lane) and ``zpack_tpu/kernels/xxh3_jax.py`` (one stream, the per-block
scramble carried by a ``lax.scan``).  Each kernel has two halves:

* a plain PyTorch version (``accumulate_batch_plain``,
  ``accumulate_stream_plain``, ``finish_plain``) that states the contract
  and runs on any device;
* a wrapper (``accumulate_batch``, ``accumulate_stream``) that takes the
  plain version for a tensor on the CPU and launches the hand-written CUDA
  kernel (``csrc/xxh3_batch.cu``, ``csrc/xxh3_stream.cu``) for a tensor on
  a GPU.  It never falls back: a build or launch error raises.

The plain versions carry u64 values in int64 tensors: multiplication and
addition wrap mod 2^64 there, and every right shift is masked, since ``>>``
on int64 is arithmetic.  The state that crosses between the packages is the
accumulator after a stream's whole stripes, ``(n, 8)`` int64 holding u64
bits; :func:`acc_from_jax` turns the JAX kernels' u32 halves into it.

The constants and the host reference come from ``codecs/xxh3.py``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..codecs import xxh3 as H
from ..utils.observe import launched

from . import _build

_M32 = 0xFFFFFFFF
_STRIPE = H.STRIPE_LEN
_SPB = H.STRIPES_PER_BLOCK
_BLOCK = H.BLOCK_LEN
_ALIGN = 16  # each packed stream starts on a multiple of this


def _secret_words(offset: int, count: int = 8) -> torch.Tensor:
    """``count`` little-endian u64 words of kSecret from byte ``offset``."""
    w = np.frombuffer(H.KSECRET, dtype="<u8", count=count, offset=offset)
    return torch.from_numpy(w.astype(np.uint64).view(np.int64).copy())


_INIT_ACC = torch.from_numpy(np.array(H._INIT_ACC, dtype=np.uint64).view(np.int64).copy())
_KEY_SECRET = torch.from_numpy(H._KSECRET_LANES.view(np.int64).copy())  # (16, 8)
_SCRAMBLE_SECRET = _secret_words(H.SECRET_SIZE - _STRIPE)
_LAST_SECRET = _secret_words(H.SECRET_SIZE - _STRIPE - H._SECRET_LASTACC_START)
_MERGE_SECRET = _secret_words(H._SECRET_MERGEACCS_START)
_SWAP = torch.from_numpy(H._SWAP_IDX.astype(np.int64))
_PRIME64_1 = H.PRIME64_1 - (1 << 64)  # the same u64 bits as an int64
_KSECRET = torch.frombuffer(bytearray(H.KSECRET), dtype=torch.uint8)


@functools.lru_cache(maxsize=None)
def secret_tensor(device) -> torch.Tensor:
    """kSecret, the 192-byte secret of seed 0, as a uint8 tensor on
    ``device`` (made once per device)."""
    return _KSECRET.to(device)


# ---------------------------------------------------------------------------
# u64 arithmetic on int64 tensors
# ---------------------------------------------------------------------------


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits in ``x``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mul_lo_hi(key: torch.Tensor) -> torch.Tensor:
    """lo32(key) * hi32(key), one exact 64-bit product."""
    return (key & _M32) * _lsr(key, 32)


def _scramble(acc: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """scrambleAcc: acc ^= acc >> 47; acc ^= secret tail; acc *= PRIME32_1."""
    return (acc ^ _lsr(acc, 47) ^ tail) * H.PRIME32_1


def _mul128_fold64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low half XOR high half of the 128-bit product a * b, from 32-bit
    limbs (each partial product fits in 64 bits)."""
    a0, a1 = a & _M32, _lsr(a, 32)
    b0, b1 = b & _M32, _lsr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _lsr(p00, 32) + (p01 & _M32) + (p10 & _M32)  # < 2^34
    lo = (p00 & _M32) | (mid << 32)
    hi = p11 + _lsr(p01, 32) + _lsr(p10, 32) + _lsr(mid, 32)
    return lo ^ hi


def _avalanche3(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr(h, 37)
    h = h * H.PRIME_MX1
    return h ^ _lsr(h, 32)


def _stripe_sums(words: torch.Tensor, key_secret: torch.Tensor) -> torch.Tensor:
    """Per-stripe contributions of ``(..., 8)`` data words:
    ``lo32(k) * hi32(k)`` plus the pair-swapped data, k = data ^ secret."""
    return _mul_lo_hi(words ^ key_secret) + words[..., _SWAP.to(words.device)]


def _u64_words(data: torch.Tensor) -> torch.Tensor:
    """A uint8 tensor's bytes as little-endian int64 words (a view where the
    bytes are 8-aligned, a copy where they are not)."""
    if data.storage_offset() % 8:
        data = data.clone()
    return data.view(torch.int64)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def pack(streams: list[bytes]) -> torch.Tensor:
    """Pack byte streams for :func:`accumulate_batch` as one uint8 CPU
    tensor: the ``(n, 2)`` int64 rows ``(start, length)``, then the streams,
    each starting on a multiple of 16 bytes of the data part.  One
    ``join``, so it is one host copy and, on the way to a GPU, one h2d
    copy.  :func:`split_packed` takes it apart (on any device)."""
    n = len(streams)
    lengths = np.fromiter(map(len, streams), dtype=np.int64, count=n)
    padded = -(-lengths // _ALIGN) * _ALIGN
    starts = np.cumsum(padded) - padded
    rows = np.stack([starts, lengths], axis=1).astype("<i8")
    zeros = bytes(_ALIGN)
    parts = [rows.tobytes()]
    for s, pad in zip(streams, (padded - lengths).tolist()):
        parts.append(s)
        parts.append(zeros[:pad])
    return torch.frombuffer(bytearray().join(parts), dtype=torch.uint8)


def split_packed(buf: torch.Tensor, n: int):
    """``(flat, offsets)`` views of a :func:`pack` buffer of ``n`` streams."""
    head = 16 * n
    return buf[head:], buf[:head].view(torch.int64).view(n, 2)


# ---------------------------------------------------------------------------
# Many streams (replaces xxh3_pallas._kernel)
# ---------------------------------------------------------------------------


def _check_batch(flat: torch.Tensor, offsets: torch.Tensor) -> None:
    if flat.dtype != torch.uint8 or flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError("flat must be a contiguous 1-D uint8 tensor")
    if (offsets.dtype != torch.int64 or offsets.dim() != 2 or offsets.shape[1] != 2
            or not offsets.is_contiguous()):
        raise ValueError("offsets must be a contiguous (n, 2) int64 tensor")
    if offsets.device != flat.device:
        raise ValueError("flat and offsets must be on one device")


def _check_rows(flat: torch.Tensor, offsets: torch.Tensor) -> None:
    start, length = offsets[:, 0], offsets[:, 1]
    bad = ((length <= H.MIDSIZE_MAX) | (start < 0) | (start % 8 != 0)
           | (start + length > flat.numel()))
    if bool(bad.any()):
        raise ValueError("every row must start on a multiple of 8 bytes, lie inside "
                         f"flat and be longer than {H.MIDSIZE_MAX} bytes")


def accumulate_batch_plain(flat: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The XXH3 accumulator of every stream after its ``(L-1)//64`` whole
    stripes, with the scramble after each full 16-stripe (1 KiB) block, in
    plain PyTorch: what ``xxh3_pallas._run`` returns, as ``(n, 8)`` int64.

    Stream i is ``flat[start:start+L]`` for the row ``offsets[i] = (start,
    L)``: start a multiple of 8, L > 240; rows may overlap.  Vectorised
    across streams, a loop over 1 KiB blocks with a per-stream stripe mask,
    as the Pallas grid walks them."""
    _check_batch(flat, offsets)
    _check_rows(flat, offsets)
    dev = flat.device
    n = offsets.shape[0]
    acc = _INIT_ACC.to(dev).expand(n, 8).clone()
    if n == 0:
        return acc
    start, length = offsets[:, 0:1], offsets[:, 1]
    nstripes = (length - 1) // _STRIPE
    key_secret = _KEY_SECRET.to(dev)
    tail = _SCRAMBLE_SECRET.to(dev)
    within = torch.arange(_BLOCK, device=dev)
    stripe = torch.arange(_SPB, device=dev)
    last = flat.numel() - 1
    for g in range(-(-int(nstripes.max()) // _SPB)):
        idx = (start + g * _BLOCK + within).clamp_(max=last)
        words = flat[idx].view(torch.int64).view(n, _SPB, 8)
        live = (g * _SPB + stripe) < nstripes[:, None]  # (n, 16)
        acc += torch.where(live[:, :, None], _stripe_sums(words, key_secret), 0).sum(1)
        full = ((g + 1) * _SPB <= nstripes)[:, None]
        acc = torch.where(full, _scramble(acc, tail), acc)
    return acc


def _last_stripes(flat: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Each stream's last 64 bytes (which may overlap its whole stripes) as
    ``(n, 8)`` int64 words."""
    idx = (offsets[:, 0] + offsets[:, 1] - _STRIPE)[:, None] + torch.arange(
        _STRIPE, device=flat.device)
    return flat[idx].view(torch.int64).view(-1, 8)


def finish_plain(acc: torch.Tensor, last64: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """XXH3-64 of streams from their accumulators after the whole stripes
    ``(n, 8)``, their last 64 bytes ``(n, 8)`` and their lengths ``(n,)``:
    the last-stripe step with the secret at ``SECRET_SIZE - 64 - 7``, then
    ``_merge_accs`` from ``length * PRIME64_1``.  Returns ``(n,)`` int64
    holding the u64 hashes."""
    dev = acc.device
    key = last64 ^ _LAST_SECRET.to(dev)
    acc = acc + _mul_lo_hi(key) + last64[:, _SWAP.to(dev)]
    x = acc ^ _MERGE_SECRET.to(dev)
    folds = _mul128_fold64(x[:, 0::2], x[:, 1::2]).sum(1)
    return _avalanche3(length * _PRIME64_1 + folds)


def hash_batch_plain(flat: torch.Tensor, offsets: torch.Tensor):
    """``(acc, hash)`` of :func:`accumulate_batch`, in plain PyTorch."""
    acc = accumulate_batch_plain(flat, offsets)
    return acc, finish_plain(acc, _last_stripes(flat, offsets), offsets[:, 1])


def _check_secret(secret: torch.Tensor, device: torch.device) -> None:
    if (secret.dtype != torch.uint8 or secret.shape != (H.SECRET_SIZE,)
            or not secret.is_contiguous() or secret.device != device):
        raise ValueError(f"secret must be a contiguous ({H.SECRET_SIZE},) uint8 "
                         f"tensor on {device}")
    if device.type == "cpu" and not torch.equal(secret, _KSECRET):
        raise ValueError("the plain versions hold kSecret only")


def batch_shape(n: int) -> dict:
    """The CUDA many-stream kernel's launch for ``n`` rows on the current
    GPU: ``grid`` (a CTA a row), ``threads`` a CTA and ``per_sm``, the CTAs
    one SM holds at once."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().zp_xxh3_batch_shape(n, out), "xxh3_batch shape")
    return dict(zip(("grid", "threads", "per_sm"), out))


def accumulate_batch(flat: torch.Tensor, offsets: torch.Tensor, secret: torch.Tensor):
    """:func:`hash_batch_plain` on the CPU; on a GPU, the CUDA many-stream
    kernel (``csrc/xxh3_batch.cu``): a CTA a row, seven warps on the block
    sums and eight lanes on the chain.  Returns ``(acc (n, 8), hash (n,))``,
    int64 tensors holding u64 bits.

    ``secret`` is :func:`secret_tensor` of the device.  The kernel takes any
    192-byte secret; the plain versions hold kSecret only, so another one
    raises on the CPU.  On the GPU ``flat`` must start on an 8-byte
    boundary, and the rows are not read back to be checked (that would
    synchronise): a row the plain version rejects reads nothing and yields
    zeros."""
    _check_batch(flat, offsets)
    _check_secret(secret, flat.device)
    if flat.device.type == "cpu":
        return hash_batch_plain(flat, offsets)
    if flat.device.type != "cuda":
        raise ValueError("accumulate_batch takes CPU or CUDA tensors")
    if flat.data_ptr() % 8:
        raise ValueError("flat must start on an 8-byte boundary")
    n = offsets.shape[0]
    acc = torch.empty((n, 8), dtype=torch.int64, device=flat.device)
    hashes = torch.empty((n,), dtype=torch.int64, device=flat.device)
    if n == 0:
        return acc, hashes
    lib = _build.lib()
    with torch.cuda.device(flat.device):
        rc = lib.zp_xxh3_batch(
            flat.data_ptr(), flat.numel(), offsets.data_ptr(), n, secret.data_ptr(),
            acc.data_ptr(), hashes.data_ptr(),
            torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(rc, "xxh3_batch")
    launched("xxh3_batch")
    return acc, hashes


# ---------------------------------------------------------------------------
# One long stream (replaces xxh3_jax._accumulate)
# ---------------------------------------------------------------------------


def _check_stream(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if data.numel() <= H.MIDSIZE_MAX:
        raise ValueError(f"data must be longer than {H.MIDSIZE_MAX} bytes")


def accumulate_stream_plain(data: torch.Tensor) -> torch.Tensor:
    """The accumulator of one stream after its whole stripes, ``(8,)``
    int64: what ``xxh3_jax._accumulate`` returns.  The 1 KiB block sums are
    vectorised; a loop carries the scramble from block to block, which is
    the spec's sequential chain."""
    _check_stream(data)
    dev = data.device
    nstripes = (data.numel() - 1) // _STRIPE
    nblocks, rem = divmod(nstripes, _SPB)
    words = _u64_words(data[: nstripes * _STRIPE]).view(nstripes, 8)
    key_secret = _KEY_SECRET.to(dev)
    acc = _INIT_ACC.to(dev)
    if nblocks:
        blocks = words[: nblocks * _SPB].view(nblocks, _SPB, 8)
        sums = _stripe_sums(blocks, key_secret).sum(1)  # (nblocks, 8)
        tail = _SCRAMBLE_SECRET.to(dev)
        for c in sums:
            acc = _scramble(acc + c, tail)
    if rem:
        acc = acc + _stripe_sums(words[nblocks * _SPB:], key_secret[:rem]).sum(0)
    return acc


def hash_stream_plain(data: torch.Tensor):
    """``(acc (8,), hash (1,))`` of :func:`accumulate_stream`, in plain
    PyTorch."""
    acc = accumulate_stream_plain(data)
    last = _u64_words(data[-_STRIPE:]).view(1, 8)
    length = torch.full((1,), data.numel(), dtype=torch.int64, device=data.device)
    return acc, finish_plain(acc.view(1, 8), last, length)


def accumulate_stream(data: torch.Tensor, secret: torch.Tensor):
    """:func:`hash_stream_plain` on the CPU; on a GPU, the CUDA single-stream
    kernel (``csrc/xxh3_stream.cu``): block sums over the whole card, then
    one warp walks the chain.  Returns ``(acc (8,), hash (1,))`` int64.
    On the GPU ``data`` must start on an 8-byte boundary."""
    _check_stream(data)
    _check_secret(secret, data.device)
    if data.device.type == "cpu":
        return hash_stream_plain(data)
    if data.device.type != "cuda":
        raise ValueError("accumulate_stream takes CPU or CUDA tensors")
    if data.data_ptr() % 8:
        raise ValueError("data must start on an 8-byte boundary")
    nblocks = (data.numel() - 1) // _STRIPE // _SPB
    sums = torch.empty((max(nblocks, 1), 8), dtype=torch.int64, device=data.device)
    acc = torch.empty((8,), dtype=torch.int64, device=data.device)
    hashes = torch.empty((1,), dtype=torch.int64, device=data.device)
    lib = _build.lib()
    with torch.cuda.device(data.device):
        rc = lib.zp_xxh3_stream(
            data.data_ptr(), data.numel(), secret.data_ptr(), sums.data_ptr(),
            acc.data_ptr(), hashes.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(rc, "xxh3_stream")
    launched("xxh3_stream")
    return acc, hashes


# ---------------------------------------------------------------------------
# Entry points (xxh3_pallas.xxh3_64_batch, xxh3_jax.xxh3_64_jax)
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA GPU is visible")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _u64_list(hashes: torch.Tensor) -> list[int]:
    return hashes.cpu().numpy().view(np.uint64).tolist()


def xxh3_64_batch(streams: list[bytes], device) -> list[int]:
    """XXH3-64 (seed 0) of every stream, bit-exact with
    ``codecs.xxh3.xxh3_64``.  Streams of 240 bytes or less take the host
    short path; the longer ones are packed into one buffer (:func:`pack`),
    copied to ``device`` once and hashed by one launch, and the ``(n,)``
    hashes come back in one copy."""
    device = _device(device)
    out: list[int | None] = [None] * len(streams)
    long_idx = []
    for i, s in enumerate(streams):
        if len(s) <= H.MIDSIZE_MAX:
            out[i] = H.xxh3_64(s)
        else:
            long_idx.append(i)
    if long_idx:
        buf = pack([streams[i] for i in long_idx]).to(device)
        flat, offsets = split_packed(buf, len(long_idx))
        _, hashes = accumulate_batch(flat, offsets, secret_tensor(device))
        for i, h in zip(long_idx, _u64_list(hashes)):
            out[i] = h
    return out


def xxh3_64(data, device) -> int:
    """XXH3-64 (seed 0) of one byte string with the accumulate on
    ``device``; 240 bytes or less take the host short path."""
    device = _device(device)
    data = bytes(data)
    if len(data) <= H.MIDSIZE_MAX:
        return H.xxh3_64(data)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    _, hashes = accumulate_stream(t, secret_tensor(device))
    return _u64_list(hashes)[0]


def acc_from_jax(out_u32, n: int) -> torch.Tensor:
    """The JAX kernels' accumulators as ``(n, 8)`` int64 holding u64 bits.

    ``out_u32`` is either the Pallas output ``(16, LANES)`` u32 (rows 0-7
    the high halves, 8-15 the low ones; column k is stream k) or
    ``_accumulate``'s ``(hi, lo)`` pair of u32[8] (then n is 1)."""
    if isinstance(out_u32, tuple):
        hi, lo = (np.asarray(a).reshape(8, -1) for a in out_u32)
    else:
        a = np.asarray(out_u32)
        hi, lo = a[0:8], a[8:16]
    acc = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return torch.from_numpy(np.ascontiguousarray(acc[:, :n].T).view(np.int64))
