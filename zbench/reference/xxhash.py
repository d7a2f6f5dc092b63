"""Self-contained XXH32 / XXH64 / XXH3-64 implementations.

The ZPack format stores an XXH3-64 of each file's uncompressed bytes
(reference: docs/specs.md CDR entry "File hash"; computed at
lib/zpack_write.c:256 via XXH3_64bits and verified at lib/zpack_read.c:466).
The LZ4 frame format additionally needs XXH32 (header checksum byte and
optional content checksum) and zstd frames optionally carry the low 32 bits
of an XXH64 content checksum — so all three hashes live here.

Algorithms follow the public xxHash specification (BSD-2, Yann Collet);
the long-input XXH3 path is vectorized with numpy (stripe lanes processed as
uint64 arrays, one python step per 1024-byte block for the non-linear
scramble).  A frozen copy of the plain implementation that the port carries,
without its native fast path and its streaming states.
"""

from __future__ import annotations

import struct

import numpy as np

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

PRIME32_1 = 0x9E3779B1
PRIME32_2 = 0x85EBCA77
PRIME32_3 = 0xC2B2AE3D
PRIME32_4 = 0x27D4EB2F
PRIME32_5 = 0x165667B1

PRIME64_1 = 0x9E3779B185EBCA87
PRIME64_2 = 0xC2B2AE3D27D4EB4F
PRIME64_3 = 0x165667B19E3779F9
PRIME64_4 = 0x85EBCA77C2B2AE63
PRIME64_5 = 0x27D4EB2F165667C5

PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

# The standard 192-byte XXH3 secret (kSecret) from the xxHash specification.
KSECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)

SECRET_SIZE = 192
STRIPE_LEN = 64
STRIPES_PER_BLOCK = (SECRET_SIZE - STRIPE_LEN) // 8  # 16
BLOCK_LEN = STRIPE_LEN * STRIPES_PER_BLOCK  # 1024
MIDSIZE_MAX = 240

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK64


def _swap32(x: int) -> int:
    return int.from_bytes((x & MASK32).to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes((x & MASK64).to_bytes(8, "little"), "big")


# ---------------------------------------------------------------------------
# XXH32
# ---------------------------------------------------------------------------


def xxh32(data: bytes, seed: int = 0) -> int:
    """One-shot XXH32 (needed for LZ4 frame header/content checksums)."""
    length = len(data)
    pos = 0
    if length >= 16:
        v1 = (seed + PRIME32_1 + PRIME32_2) & MASK32
        v2 = (seed + PRIME32_2) & MASK32
        v3 = seed & MASK32
        v4 = (seed - PRIME32_1) & MASK32
        limit = length - 16
        # numpy-vectorized lane rounds: lanes are independent mod the
        # sequential carry, which *is* per-lane sequential; do it in chunks.
        while pos <= limit:
            v1 = _rotl32((v1 + _u32(data, pos)[0] * PRIME32_2) & MASK32, 13) * PRIME32_1 & MASK32
            v2 = _rotl32((v2 + _u32(data, pos + 4)[0] * PRIME32_2) & MASK32, 13) * PRIME32_1 & MASK32
            v3 = _rotl32((v3 + _u32(data, pos + 8)[0] * PRIME32_2) & MASK32, 13) * PRIME32_1 & MASK32
            v4 = _rotl32((v4 + _u32(data, pos + 12)[0] * PRIME32_2) & MASK32, 13) * PRIME32_1 & MASK32
            pos += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & MASK32
    else:
        h = (seed + PRIME32_5) & MASK32
    h = (h + length) & MASK32
    while pos + 4 <= length:
        h = (h + _u32(data, pos)[0] * PRIME32_3) & MASK32
        h = (_rotl32(h, 17) * PRIME32_4) & MASK32
        pos += 4
    while pos < length:
        h = (h + data[pos] * PRIME32_5) & MASK32
        h = (_rotl32(h, 11) * PRIME32_1) & MASK32
        pos += 1
    h ^= h >> 15
    h = (h * PRIME32_2) & MASK32
    h ^= h >> 13
    h = (h * PRIME32_3) & MASK32
    h ^= h >> 16
    return h


class XXH32State:
    """Streaming XXH32 (LZ4 frame content checksums over chunked writes)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._buf = bytearray()
        self._total = 0
        self._v = None  # type: list[int] | None

    def update(self, data: bytes) -> "XXH32State":
        self._buf += data
        self._total += len(data)
        n = (len(self._buf) // 16) * 16
        if n:
            chunk = bytes(self._buf[:n])
            del self._buf[:n]
            if self._v is None:
                s = self.seed
                self._v = [
                    (s + PRIME32_1 + PRIME32_2) & MASK32,
                    (s + PRIME32_2) & MASK32,
                    s & MASK32,
                    (s - PRIME32_1) & MASK32,
                ]
            v = self._v
            for pos in range(0, n, 16):
                for i in range(4):
                    v[i] = (
                        _rotl32((v[i] + _u32(chunk, pos + 4 * i)[0] * PRIME32_2) & MASK32, 13)
                        * PRIME32_1
                        & MASK32
                    )
        return self

    def digest(self) -> int:
        if self._v is not None:
            v = self._v
            h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12) + _rotl32(v[3], 18)) & MASK32
        else:
            h = (self.seed + PRIME32_5) & MASK32
        h = (h + self._total) & MASK32
        buf = bytes(self._buf)
        pos = 0
        while pos + 4 <= len(buf):
            h = (h + _u32(buf, pos)[0] * PRIME32_3) & MASK32
            h = (_rotl32(h, 17) * PRIME32_4) & MASK32
            pos += 4
        while pos < len(buf):
            h = (h + buf[pos] * PRIME32_5) & MASK32
            h = (_rotl32(h, 11) * PRIME32_1) & MASK32
            pos += 1
        h ^= h >> 15
        h = (h * PRIME32_2) & MASK32
        h ^= h >> 13
        h = (h * PRIME32_3) & MASK32
        h ^= h >> 16
        return h


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------


def _xxh64_round(acc: int, inp: int) -> int:
    acc = (acc + inp * PRIME64_2) & MASK64
    return (_rotl64(acc, 31) * PRIME64_1) & MASK64


def _xxh64_merge(acc: int, val: int) -> int:
    acc ^= _xxh64_round(0, val)
    return (acc * PRIME64_1 + PRIME64_4) & MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    """One-shot XXH64 (zstd frame content checksum = its low 32 bits)."""
    length = len(data)
    pos = 0
    if length >= 32:
        v1 = (seed + PRIME64_1 + PRIME64_2) & MASK64
        v2 = (seed + PRIME64_2) & MASK64
        v3 = seed & MASK64
        v4 = (seed - PRIME64_1) & MASK64
        limit = length - 32
        while pos <= limit:
            v1 = _xxh64_round(v1, _u64(data, pos)[0])
            v2 = _xxh64_round(v2, _u64(data, pos + 8)[0])
            v3 = _xxh64_round(v3, _u64(data, pos + 16)[0])
            v4 = _xxh64_round(v4, _u64(data, pos + 24)[0])
            pos += 32
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & MASK64
        h = _xxh64_merge(h, v1)
        h = _xxh64_merge(h, v2)
        h = _xxh64_merge(h, v3)
        h = _xxh64_merge(h, v4)
    else:
        h = (seed + PRIME64_5) & MASK64
    h = (h + length) & MASK64
    while pos + 8 <= length:
        h ^= _xxh64_round(0, _u64(data, pos)[0])
        h = (_rotl64(h, 27) * PRIME64_1 + PRIME64_4) & MASK64
        pos += 8
    if pos + 4 <= length:
        h ^= (_u32(data, pos)[0] * PRIME64_1) & MASK64
        h = (_rotl64(h, 23) * PRIME64_2 + PRIME64_3) & MASK64
        pos += 4
    while pos < length:
        h ^= (data[pos] * PRIME64_5) & MASK64
        h = (_rotl64(h, 11) * PRIME64_1) & MASK64
        pos += 1
    h ^= h >> 33
    h = (h * PRIME64_2) & MASK64
    h ^= h >> 29
    h = (h * PRIME64_3) & MASK64
    h ^= h >> 32
    return h


class XXH64State:
    """Streaming XXH64."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._buf = bytearray()
        self._total = 0
        self._v = None

    def update(self, data: bytes) -> "XXH64State":
        self._buf += data
        self._total += len(data)
        n = (len(self._buf) // 32) * 32
        if n:
            chunk = bytes(self._buf[:n])
            del self._buf[:n]
            if self._v is None:
                s = self.seed
                self._v = [
                    (s + PRIME64_1 + PRIME64_2) & MASK64,
                    (s + PRIME64_2) & MASK64,
                    s & MASK64,
                    (s - PRIME64_1) & MASK64,
                ]
            v = self._v
            for pos in range(0, n, 32):
                for i in range(4):
                    v[i] = _xxh64_round(v[i], _u64(chunk, pos + 8 * i)[0])
        return self

    def digest(self) -> int:
        if self._v is not None:
            v = self._v
            h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)) & MASK64
            for vi in v:
                h = _xxh64_merge(h, vi)
        else:
            h = (self.seed + PRIME64_5) & MASK64
        h = (h + self._total) & MASK64
        buf = bytes(self._buf)
        pos = 0
        while pos + 8 <= len(buf):
            h ^= _xxh64_round(0, _u64(buf, pos)[0])
            h = (_rotl64(h, 27) * PRIME64_1 + PRIME64_4) & MASK64
            pos += 8
        if pos + 4 <= len(buf):
            h ^= (_u32(buf, pos)[0] * PRIME64_1) & MASK64
            h = (_rotl64(h, 23) * PRIME64_2 + PRIME64_3) & MASK64
            pos += 4
        while pos < len(buf):
            h ^= (buf[pos] * PRIME64_5) & MASK64
            h = (_rotl64(h, 11) * PRIME64_1) & MASK64
            pos += 1
        h ^= h >> 33
        h = (h * PRIME64_2) & MASK64
        h ^= h >> 29
        h = (h * PRIME64_3) & MASK64
        h ^= h >> 32
        return h


# ---------------------------------------------------------------------------
# XXH3-64
# ---------------------------------------------------------------------------


def _avalanche64(h: int) -> int:
    h ^= h >> 33
    h = (h * PRIME64_2) & MASK64
    h ^= h >> 29
    h = (h * PRIME64_3) & MASK64
    h ^= h >> 32
    return h


def _avalanche3(h: int) -> int:
    h &= MASK64
    h ^= h >> 37
    h = (h * PRIME_MX1) & MASK64
    h ^= h >> 32
    return h


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return ((p & MASK64) ^ (p >> 64)) & MASK64


def _mix16b(data: bytes, doff: int, secret: bytes, soff: int, seed: int) -> int:
    lo = _u64(data, doff)[0] ^ ((_u64(secret, soff)[0] + seed) & MASK64)
    hi = _u64(data, doff + 8)[0] ^ ((_u64(secret, soff + 8)[0] - seed) & MASK64)
    return _mul128_fold64(lo, hi)


def derive_secret(seed: int) -> bytes:
    """Per-seed custom secret (XXH3_initCustomSecret in the spec)."""
    if seed == 0:
        return KSECRET
    out = bytearray(SECRET_SIZE)
    for i in range(SECRET_SIZE // 16):
        lo = (_u64(KSECRET, 16 * i)[0] + seed) & MASK64
        hi = (_u64(KSECRET, 16 * i + 8)[0] - seed) & MASK64
        out[16 * i : 16 * i + 8] = lo.to_bytes(8, "little")
        out[16 * i + 8 : 16 * i + 16] = hi.to_bytes(8, "little")
    return bytes(out)


def _xxh3_0to16(data: bytes, seed: int, secret: bytes) -> int:
    length = len(data)
    if length > 8:
        bitflip1 = ((_u64(secret, 24)[0] ^ _u64(secret, 32)[0]) + seed) & MASK64
        bitflip2 = ((_u64(secret, 40)[0] ^ _u64(secret, 48)[0]) - seed) & MASK64
        input_lo = _u64(data, 0)[0] ^ bitflip1
        input_hi = _u64(data, length - 8)[0] ^ bitflip2
        acc = (
            length
            + _swap64(input_lo)
            + input_hi
            + _mul128_fold64(input_lo, input_hi)
        ) & MASK64
        return _avalanche3(acc)
    if length >= 4:
        seed ^= (_swap32(seed & MASK32) << 32) & MASK64
        input1 = _u32(data, 0)[0]
        input2 = _u32(data, length - 4)[0]
        bitflip = ((_u64(secret, 8)[0] ^ _u64(secret, 16)[0]) - seed) & MASK64
        input64 = (input2 + (input1 << 32)) & MASK64
        keyed = input64 ^ bitflip
        # rrmxmx
        h = (keyed ^ _rotl64(keyed, 49) ^ _rotl64(keyed, 24)) & MASK64
        h = (h * PRIME_MX2) & MASK64
        h ^= ((h >> 35) + length) & MASK64
        h = (h * PRIME_MX2) & MASK64
        h ^= h >> 28
        return h
    if length > 0:
        c1, c2, c3 = data[0], data[length >> 1], data[length - 1]
        combined = ((c1 << 16) | (c2 << 24) | c3 | (length << 8)) & MASK32
        bitflip = ((_u32(secret, 0)[0] ^ _u32(secret, 4)[0]) + seed) & MASK64
        return _avalanche64((combined ^ bitflip) & MASK64)
    bitflip = (_u64(secret, 56)[0] ^ _u64(secret, 64)[0]) & MASK64
    return _avalanche64((seed ^ bitflip) & MASK64)


def _xxh3_17to128(data: bytes, seed: int, secret: bytes) -> int:
    length = len(data)
    acc = (length * PRIME64_1) & MASK64
    if length > 32:
        if length > 64:
            if length > 96:
                acc = (acc + _mix16b(data, 48, secret, 96, seed)) & MASK64
                acc = (acc + _mix16b(data, length - 64, secret, 112, seed)) & MASK64
            acc = (acc + _mix16b(data, 32, secret, 64, seed)) & MASK64
            acc = (acc + _mix16b(data, length - 48, secret, 80, seed)) & MASK64
        acc = (acc + _mix16b(data, 16, secret, 32, seed)) & MASK64
        acc = (acc + _mix16b(data, length - 32, secret, 48, seed)) & MASK64
    acc = (acc + _mix16b(data, 0, secret, 0, seed)) & MASK64
    acc = (acc + _mix16b(data, length - 16, secret, 16, seed)) & MASK64
    return _avalanche3(acc)


_MIDSIZE_STARTOFFSET = 3
_MIDSIZE_LASTOFFSET = 17


def _xxh3_129to240(data: bytes, seed: int, secret: bytes) -> int:
    length = len(data)
    acc = (length * PRIME64_1) & MASK64
    nb_rounds = length // 16
    for i in range(8):
        acc = (acc + _mix16b(data, 16 * i, secret, 16 * i, seed)) & MASK64
    acc = _avalanche3(acc)
    for i in range(8, nb_rounds):
        acc = (
            acc + _mix16b(data, 16 * i, secret, 16 * (i - 8) + _MIDSIZE_STARTOFFSET, seed)
        ) & MASK64
    acc = (
        acc + _mix16b(data, length - 16, secret, 136 - _MIDSIZE_LASTOFFSET, seed)
    ) & MASK64
    return _avalanche3(acc)


_INIT_ACC = (
    PRIME32_3,
    PRIME64_1,
    PRIME64_2,
    PRIME64_3,
    PRIME64_4,
    PRIME32_2,
    PRIME64_5,
    PRIME32_1,
)

_SECRET_LASTACC_START = 7
_SECRET_MERGEACCS_START = 11

_SWAP_IDX = np.array([1, 0, 3, 2, 5, 4, 7, 6])


def _secret_lanes(secret: bytes) -> np.ndarray:
    """secret as overlapping u64 lanes at byte offsets 8*s for each stripe s:
    shape (STRIPES_PER_BLOCK, 8)."""
    out = np.empty((STRIPES_PER_BLOCK, 8), dtype=np.uint64)
    for s in range(STRIPES_PER_BLOCK):
        out[s] = np.frombuffer(secret, dtype="<u8", count=8, offset=8 * s)
    return out


_KSECRET_LANES = _secret_lanes(KSECRET)


def _accumulate_block_sums(stripes: np.ndarray, secret_lanes: np.ndarray):
    """Vectorized per-stripe contributions.

    ``stripes``: (n, 8) uint64 little-endian lanes of n consecutive stripes,
    where stripe i uses secret lane row (i mod 16) — callers must align so
    that row 0 corresponds to stripe-position 0 within the current block.

    Returns (mul_contrib, swapped_data) each (n, 8) uint64:
      acc[i]   += (key & 0xffffffff) * (key >> 32)   [mul_contrib]
      acc[i^1] += data_val                            [swapped_data]
    """
    n = stripes.shape[0]
    key = stripes ^ secret_lanes[:n]
    lo = key & np.uint64(MASK32)
    hi = key >> np.uint64(32)
    mul = lo * hi  # exact in uint64
    swapped = stripes[:, _SWAP_IDX]
    return mul, swapped


def _scramble(acc: np.ndarray, secret: bytes) -> None:
    """scrambleAcc: acc ^= acc>>47; acc ^= secret_tail; acc *= PRIME32_1."""
    tail = np.frombuffer(secret, dtype="<u8", count=8, offset=SECRET_SIZE - STRIPE_LEN)
    acc ^= acc >> np.uint64(47)
    acc ^= tail
    acc *= np.uint64(PRIME32_1)


def _merge_accs(acc: np.ndarray, secret: bytes, start: int) -> int:
    result = start & MASK64
    a = [int(x) for x in acc]
    for i in range(4):
        lo = a[2 * i] ^ _u64(secret, _SECRET_MERGEACCS_START + 16 * i)[0]
        hi = a[2 * i + 1] ^ _u64(secret, _SECRET_MERGEACCS_START + 16 * i + 8)[0]
        result = (result + _mul128_fold64(lo, hi)) & MASK64
    return _avalanche3(result)


def _hash_long(data: bytes, secret: bytes) -> int:
    length = len(data)
    acc = np.array(_INIT_ACC, dtype=np.uint64)
    sec_lanes = _KSECRET_LANES if secret is KSECRET else _secret_lanes(secret)

    nb_stripes_total = (length - 1) // STRIPE_LEN
    # All whole stripes as (n, 8) u64 lanes.
    arr = np.frombuffer(data, dtype="<u8", count=nb_stripes_total * 8)
    stripes = arr.reshape(nb_stripes_total, 8)

    # Process in blocks of 16 stripes; the scramble between blocks is the
    # only sequential dependency.
    nb_blocks = nb_stripes_total // STRIPES_PER_BLOCK
    if nb_blocks:
        blk = stripes[: nb_blocks * STRIPES_PER_BLOCK].reshape(
            nb_blocks, STRIPES_PER_BLOCK, 8
        )
        key = blk ^ sec_lanes  # broadcast over blocks
        mul = (key & np.uint64(MASK32)) * (key >> np.uint64(32))
        mul_sums = mul.sum(axis=1, dtype=np.uint64)  # (nb_blocks, 8)
        data_sums = blk[:, :, _SWAP_IDX].sum(axis=1, dtype=np.uint64)
        for b in range(nb_blocks):
            acc += mul_sums[b]
            acc += data_sums[b]
            _scramble(acc, secret)
    # Last partial block.
    rem = stripes[nb_blocks * STRIPES_PER_BLOCK :]
    if len(rem):
        mul, swapped = _accumulate_block_sums(rem, sec_lanes)
        acc += mul.sum(axis=0, dtype=np.uint64)
        acc += swapped.sum(axis=0, dtype=np.uint64)
    # Last stripe: final 64 bytes with the last-accumulator secret offset.
    last = np.frombuffer(data, dtype="<u8", count=8, offset=length - STRIPE_LEN)
    last_secret = np.frombuffer(
        secret, dtype=np.uint8, count=64, offset=SECRET_SIZE - STRIPE_LEN - _SECRET_LASTACC_START
    ).tobytes()
    lsec = np.frombuffer(last_secret, dtype="<u8", count=8)
    key = last ^ lsec
    acc += (key & np.uint64(MASK32)) * (key >> np.uint64(32))
    acc += last[_SWAP_IDX]

    return _merge_accs(acc, secret, (length * PRIME64_1) & MASK64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """One-shot XXH3-64 (bit-compatible with XXH3_64bits/_withSeed)."""
    data = bytes(data)
    length = len(data)
    if length <= 16:
        return _xxh3_0to16(data, seed, KSECRET)
    if length <= 128:
        return _xxh3_17to128(data, seed, KSECRET)
    if length <= MIDSIZE_MAX:
        return _xxh3_129to240(data, seed, KSECRET)
    return _hash_long(data, derive_secret(seed))
