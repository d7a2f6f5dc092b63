"""Windows that stress the LZ4 match finder (``lz4_torch.tokenize_est``): one
hash bucket as long as the window, buckets that cross every warp's stretch
of the kernel's radix passes, hashes at the edges of both 8-bit digits,
windows whose length is no power of two, dictionary windows, matches at the
end-of-window rules, and buckets longer than the chain depth.

:func:`cases` is the one definition; the CPU tests hold ``tokenize_plain``
against the JAX tokenizers and against a hash-chain statement of the same
function on it, and the GPU tests and ``chip_smoke.py`` hold the kernel
against ``tokenize_plain`` on the same windows.  :func:`admitted` lists the
``(mode, capj)`` pairs a case's window allows, and :func:`mixed_batch` stacks
every case into one batch of a given width, so that rows of different kinds
share a launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

HASH_MUL = 2654435761
_HASH_INV = pow(HASH_MUL, -1, 1 << 32)


class Case(NamedTuple):
    window: np.ndarray  # (W,) uint8: dict_pad dictionary bytes, then the block
    dict_pad: int = 0
    depths: tuple = (2,)


def hash16(word: bytes) -> int:
    """The matcher's hash of a 4-byte word."""
    return ((int.from_bytes(word, "little") * HASH_MUL) & 0xFFFFFFFF) >> 16


def word_with_hash(h: int, low: int = 0) -> bytes:
    """A 4-byte word whose hash is ``h``; ``low`` picks one of the 65,536."""
    return ((((h << 16) | low) * _HASH_INV) & 0xFFFFFFFF).to_bytes(4, "little")


def _noise(rng, n: int) -> np.ndarray:
    return rng.integers(0, 256, n, dtype=np.uint8)


def _texty(rng, n: int) -> np.ndarray:
    """Words from a short list, so that matches of many lengths occur; from
    200 bytes on the last 40 bytes repeat bytes 100..140, so matches run
    into the end-of-window rules."""
    words = [b"radix ", b"chain ", b"bucket ", b"warp ", b"stretch ", b"digit ", b"of ", b"a "]
    out = b"".join(words[i] for i in rng.integers(0, len(words), n // 2 + 1))[:n]
    arr = np.frombuffer(out, np.uint8).copy()
    if n >= 200:
        arr[n - 40:] = arr[100:140]
    return arr


def _distinct_hashes(n: int) -> np.ndarray:
    """``n`` bytes whose ``n`` hashes (zeros past the end) are all distinct."""
    for seed in range(100):
        rng = np.random.default_rng(seed)
        out = bytearray(_noise(rng, 3).tobytes())
        seen = set()
        for p in range(n - 3):
            for b in rng.permutation(256).tolist():
                h = hash16(bytes(out[p:p + 3]) + bytes([b]))
                if h not in seen:
                    break
            seen.add(h)
            out.append(b)
        tail = {hash16(bytes(out[p:p + 4]).ljust(4, b"\0")) for p in range(n - 3, n)}
        if len(tail) == 3 and not tail & seen:
            return np.frombuffer(bytes(out), np.uint8).copy()
    raise AssertionError("no window of distinct hashes found")


#: hashes at both ends and at the middle of the low and of the high digit
EDGE_HASHES = (0x0000, 0x00FF, 0x0100, 0x7FFF, 0x8000, 0xFF00, 0xFFFF)


def _straddle(rng, n: int, step: int) -> np.ndarray:
    """Noise with one marker word per hash of :data:`EDGE_HASHES` every
    ``step`` bytes, each followed by 4 bytes of two symbols: every marker's
    bucket has members in every warp's stretch of both radix passes, and its
    candidates match over 4 to 8 bytes."""
    arr = _noise(rng, n)
    for base in range(0, n - 8 * len(EDGE_HASHES), step):
        for k, h in enumerate(EDGE_HASHES):
            at = base + 8 * k
            arr[at:at + 4] = np.frombuffer(word_with_hash(h, 7), np.uint8)
            arr[at + 4:at + 8] = rng.integers(97, 99, 4)
    return arr


def _deep_bucket(rng, n: int, members: int) -> np.ndarray:
    """One marker ``members`` times, each followed by 12 bytes of two
    symbols: the longest candidate is often far down the chain, so every
    depth gives other tables."""
    arr = _noise(rng, n)
    gap = n // (members + 1)
    for k in range(members):
        at = 16 + k * gap
        arr[at:at + 4] = np.frombuffer(word_with_hash(0x1234, 1), np.uint8)
        arr[at + 4:at + 16] = rng.integers(97, 99, 12)
    return arr


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    # one bucket of 65,536, a chain 65,535 links deep
    out["zeros 65536"] = Case(np.zeros(65536, np.uint8), depths=(2, 64))
    # four buckets of about 16,384 each
    out["period 4"] = Case(np.frombuffer(b"abcd" * 16384, np.uint8).copy())
    # no bucket has two members: no candidate anywhere
    out["distinct hashes"] = Case(_distinct_hashes(4096))
    # buckets across every stretch, hashes at the digits' edges; both shapes
    out["straddle 65536"] = Case(_straddle(rng, 65536, 448), depths=(2, 8))
    out["straddle 8192"] = Case(_straddle(rng, 8192, 200), depths=(2, 8))
    # window lengths that are no power of two, down to one byte
    out["W 1"] = Case(_texty(rng, 1), depths=(1,))
    out["W 12"] = Case(np.frombuffer(b"abcdabcdabcd", np.uint8).copy())
    out["W 13"] = Case(np.frombuffer(b"abcdabcdabcda", np.uint8).copy())
    out["W 4097"] = Case(_texty(rng, 4097))
    out["W 65535"] = Case(_texty(rng, 65535))
    # the dictionary path's windows: 4 KiB and 8 KiB blocks behind 2 KiB
    out["W 6144 dictionary 2048"] = Case(_texty(rng, 6144), dict_pad=2048)
    out["W 10240 dictionary 2048"] = Case(_texty(rng, 10240), dict_pad=2048)
    # the last 40 bytes repeat bytes 100..140 of noise: the match at W - 13
    # is the last one allowed and is cut to end at W - 5
    ends = _noise(rng, 8192)
    ends[8192 - 40:] = ends[100:140]
    out["matches into the end rules"] = Case(ends)
    # a bucket of 200 against chains of 1, 2, 8 and 64 links
    out["bucket longer than depth"] = Case(_deep_bucket(rng, 8192, 200), depths=(1, 2, 8, 64))
    return out


def admitted(case: Case) -> list:
    """The ``(mode, capj)`` pairs the case's window allows: "pair" at the
    main path's cap 8 and at 16, "u16" up to 8 KiB, "hash" without a
    dictionary at both caps, "scatter" at 16."""
    W = len(case.window)
    modes = [("pair", 8), ("pair", 16)]
    if W <= 8192:
        modes.append(("u16", 8))
    if not case.dict_pad:
        modes += [("hash", 8), ("hash", 16)]
    return modes + [("scatter", 16)]


def mixed_batch(W: int, seed: int = 0) -> np.ndarray:
    """Every case's window, cut or zero-padded to ``W`` bytes, as one
    (rows, W) batch: rows of all kinds side by side in one launch."""
    rows = np.zeros((len(cases(seed)), W), np.uint8)
    for row, case in zip(rows, cases(seed).values()):
        n = min(W, len(case.window))
        row[:n] = case.window[:n]
    return rows
