"""Shared LZ77 match finder — the compute core of both the LZ4 and zstd
encoders (role parity: the match-finding inside the reference's vendored
lz4/zstd, driven from lib/zpack_write.c:179,204).

Parallel-first formulation (mirrored by the TPU kernels in
zpack_tpu.kernels): hash every 4-byte window, recover "previous occurrence"
chains with one stable argsort instead of sequential hash-table updates,
and extend candidate matches with vectorized compare rounds over a
shrinking active set.  Search depth = number of chain-follow gathers.
"""

from __future__ import annotations

import numpy as np

MIN_MATCH = 4
_HASH_MUL = np.uint32(2654435761)
CAP = 128  # vectorized extension cap; callers extend exactly past it


def u32_windows(b: np.ndarray) -> np.ndarray:
    """u32 little-endian read at every position 0..n-4 (vectorized)."""
    n = len(b)
    u = b[: n - 3].astype(np.uint32)
    u |= b[1 : n - 2].astype(np.uint32) << np.uint32(8)
    u |= b[2 : n - 1].astype(np.uint32) << np.uint32(16)
    u |= b[3:n].astype(np.uint32) << np.uint32(24)
    return u


def find_matches(b: np.ndarray, depth: int, max_offset: int,
                 hash_bits: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """For each position p return (match_src[p], match_len[p]); match_len < 4
    means no usable match.  match_len is capped at CAP."""
    n = len(b)
    if n < MIN_MATCH:
        z = np.zeros(n, dtype=np.int64)
        return z - 1, z
    u = u32_windows(b)
    m = len(u)
    if hash_bits is None:
        hash_bits = min(max(int(np.ceil(np.log2(max(m, 2)))) + 1, 12), 22)
    h = (u * _HASH_MUL) >> np.uint32(32 - hash_bits)
    order = np.argsort(h, kind="stable").astype(np.int64)
    cand = np.full(m, -1, dtype=np.int64)
    same = h[order[1:]] == h[order[:-1]]
    cand[order[1:][same]] = order[:-1][same]

    best_src = np.full(m, -1, dtype=np.int64)
    best_len = np.zeros(m, dtype=np.int64)
    cur = cand
    pos = np.arange(m, dtype=np.int64)
    for _ in range(max(1, depth)):
        valid = (cur >= 0) & (pos - cur <= max_offset)
        j = np.where(valid, cur, 0)
        valid &= u[j] == u  # reject hash collisions
        mlen = extend_matches(b, u, pos, j, valid)
        better = valid & (mlen > best_len)
        best_src = np.where(better, j, best_src)
        best_len = np.where(better, mlen, best_len)
        cur = np.where(cur >= 0, cand[np.maximum(cur, 0)], -1)
    return best_src, best_len


def extend_matches(b, u, pos, j, valid) -> np.ndarray:
    """Vectorized LCP for pairs (pos, j) where valid, from the guaranteed
    4-byte match, capped at CAP."""
    n = len(b)
    m = len(u)
    mlen = np.where(valid, MIN_MATCH, 0).astype(np.int64)
    active = np.flatnonzero(valid)
    k = MIN_MATCH
    while len(active) and k < CAP:
        p_a = pos[active] + k
        inb = p_a <= m - 1
        eq = np.zeros(len(active), dtype=bool)
        if inb.any():
            ia = active[inb]
            eq[inb] = u[pos[ia] + k] == u[j[ia] + k]
        mlen[active[eq]] += 4
        done = active[~eq]
        if len(done):
            for _ in range(3):
                pp = pos[done] + mlen[done]
                ok = pp < n
                oki = done[ok]
                still = b[pos[oki] + mlen[oki]] == b[j[oki] + mlen[oki]]
                mlen[oki[still]] += 1
        active = active[eq]
        k += 4
    return mlen


def exact_extend(b: np.ndarray, p: int, j: int, start: int, limit: int) -> int:
    """Exact extension past CAP: common-prefix length of b[p+start:] and
    b[j+start:], bounded so the match ends by byte ``limit``."""
    maxlen = limit - p
    a = b[p + start : p + maxlen]
    c = b[j + start : j + maxlen]
    neq = np.flatnonzero(a != c)
    ext = int(neq[0]) if len(neq) else len(a)
    return start + ext


def greedy_parse(b: np.ndarray, src: np.ndarray, mlen: np.ndarray,
                 match_limit: int, end_limit: int, lazy: bool = False):
    """Greedy (optionally 1-step lazy) parse into sequences.

    Yields (lit_start, lit_len, match_pos, match_src, match_len) with a final
    (lit_start, lit_len, None, None, None) for trailing literals.
    ``match_limit``: last allowed match start (exclusive);
    ``end_limit``: matches must end at or before this byte.
    """
    n = len(b)
    usable = np.flatnonzero((mlen >= MIN_MATCH) & (np.arange(len(mlen)) < match_limit))
    usable = usable[usable > 0]
    pos = 0
    lit_start = 0
    nu = len(usable)
    while True:
        k = int(np.searchsorted(usable, pos))
        if k >= nu:
            break
        p = int(usable[k])
        j = int(src[p])
        ml = int(mlen[p])
        if lazy and p + 1 < match_limit and p + 1 < len(mlen):
            # 1-step lazy: prefer a strictly longer match starting next byte
            if int(mlen[p + 1]) > ml + 2 and int(mlen[p + 1]) >= MIN_MATCH:
                pos = p + 1
                continue
        if ml >= CAP:
            ml = exact_extend(b, p, j, ml, end_limit)
        ml = min(ml, end_limit - p)
        if ml < MIN_MATCH:
            pos = p + 1
            continue
        yield (lit_start, p - lit_start, p, j, ml)
        pos = p + ml
        lit_start = pos
    yield (lit_start, n - lit_start, None, None, None)
