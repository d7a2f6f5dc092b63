"""Shards that stress the LZ4 block serializer (``lz4_torch.serialize_plain``,
``csrc/lz4_serialize.cu``): a tail block shorter than the rest, blocks of 0,
5, 12, 13 and 255 bytes, incompressible blocks stored raw, runs far past the
tokenizer's length cap up to the end-of-block limit, lengths past what the
scan settles, backward extension into literals, candidates at or after
their own position, lengths the bytes do not bear out, and blocks of every
kind side by side.  :func:`hc_cases` adds the tables of the HC levels
(deeper chains, longer comparisons) and repeats planted so the HC parse's
literal steps meet every edge: a longer match one or two bytes on, one
longer by one only, chains of such steps, and lengths about the cap under
which the parse weighs them.

:func:`cases` is the one definition: the CPU tests hold ``serialize_plain``
against ``native.lz4_serialize_blocks_packed`` on it, and the GPU tests and
``chip_smoke.py`` hold the kernel against both.  A case is ``(rows, arrays,
n)``: the shard's blocks zero-padded, (nb, B) uint8, its wire arrays in the
mode asked for (numpy), and its count of data bytes.  The tables come from
``tokenize_plain`` on the data, or are written by hand in the wire format.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: the block size of every case: both wire formats take it
B = 4096


def _text(rng, n: int) -> bytes:
    words = [b"serial ", b"walker ", b"literal ", b"offset ", b"token ", b"of ", b"a "]
    return b"".join(words[i] for i in rng.integers(0, len(words), n // 3 + 1))[:n]


def _noise(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _rows(data: bytes) -> np.ndarray:
    nb = max(1, -(-len(data) // B))
    rows = np.zeros((nb, B), dtype=np.uint8)
    rows.reshape(-1)[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return rows


def _tokenized(data: bytes, mode: str, depth: int = 2, capj: int | None = None):
    from . import lz4_torch

    rows = _rows(data)
    arrays = lz4_torch.tokenize_plain(torch.from_numpy(rows), depth,
                                      capj or lz4_torch.CAPJ, mode)
    return rows, tuple(a.numpy() for a in arrays), len(data)


def _wire(src: np.ndarray, mlen: np.ndarray, mode: str) -> tuple:
    """Hand-made (nb, B) tables in ``mode``: ``src`` where ``mlen`` >= 4."""
    code = np.where(mlen >= 4, mlen - 3, 0)
    src = np.where(code > 0, src, 0)
    if mode == "pair":
        return src.astype(np.uint16), code.astype(np.uint8)
    return (((src << 3) | np.minimum(code, 7)).astype(np.uint16),)


def _by_hand(data: bytes, mode: str, src: np.ndarray, mlen: np.ndarray):
    return _rows(data), _wire(src, mlen, mode), len(data)


def _backward(rng, mode: str):
    """A 40-byte phrase twice, 300 bytes apart, with the only candidate 12
    bytes into its second copy: the match extends back 12 bytes into the
    literals, and stops at the previous sequence's end where a candidate
    sits right before the phrase."""
    phrase = _noise(rng, 40)
    data = bytearray(_noise(rng, B))
    data[100:140] = phrase
    data[400:440] = phrase
    data[1000:1040] = phrase
    data[1300:1340] = phrase
    data[1290:1300] = data[1000:1010]  # a match just before the second pair
    src = np.zeros((1, B), dtype=np.int64)
    mlen = np.zeros((1, B), dtype=np.int64)
    src[0, 412], mlen[0, 412] = 112, 4
    src[0, 1290], mlen[0, 1290] = 1000, 4
    src[0, 1312], mlen[0, 1312] = 1012, 5
    return _by_hand(bytes(data), mode, src, mlen)


def _late_sources(rng, mode: str):
    """Text with its tokenized tables, then every fourth candidate pointed at
    its own position or past it: those are rejected, the rest kept."""
    rows, arrays, n = _tokenized(_text(rng, 2 * B + 300), mode)
    from . import lz4_torch

    src, mlen = (a.astype(np.int64) for a in lz4_torch.from_jax_wire(mode, arrays))
    pos = np.arange(B)[None, :]
    late = (mlen >= 4) & (pos % 4 == 0)
    src = np.where(late, np.minimum(pos + (pos % 3), B - 1), np.maximum(src, 0))
    return rows, _wire(src, mlen, mode), n


def _long_lengths(rng, mode: str):
    """Every position's candidate the one before it, at the longest length
    the wire holds (258 in "pair", past what the scan settles; 10 in
    "u16"), over zeros, over a period-3 pattern and over noise, where the
    bytes do not bear the length out and the serializer takes it as given."""
    zeros = bytes(B)
    period = (b"abc" * B)[:B]
    data = zeros + period + _noise(rng, B - 1000)
    rows = _rows(data)
    top = 258 if mode == "pair" else 10
    pos = np.arange(rows.size).reshape(rows.shape) % B
    src = np.where(pos >= 3, pos - np.array([[1], [3], [3]]), 0)
    mlen = np.where(pos >= 3, top, 0)
    return rows, _wire(src, mlen, mode), len(data)


@functools.cache
def cases(mode: str) -> dict:
    """Every case in wire format ``mode`` ("pair" or "u16"), by name (made
    once a process; the arrays are shared, not to be written)."""
    rng = np.random.default_rng(25)
    text = _text(rng, 3 * B + 777)
    out = {
        "text, a tail block of 777 bytes": _tokenized(text, mode),
        "an empty shard": _tokenized(b"", mode),
        **{f"one block of {k} bytes": _tokenized(text[:k], mode) for k in (5, 12, 13, 255)},
        "noise: every block raw": _tokenized(_noise(rng, 2 * B + 100), mode),
        "zeros: runs to the limit": _tokenized(bytes(2 * B + 77), mode),
        "a period of two": _tokenized((b"xy" * B)[:B + 999], mode),
        "backward extension into literals": _backward(rng, mode),
        "candidates at or after their position": _late_sources(rng, mode),
        "lengths past the scan and past the bytes": _long_lengths(rng, mode),
    }
    kinds = [text[:B], _noise(rng, B), bytes(B), (b"xy" * B)[:B], text[B:B + 3000]]
    out["every kind side by side"] = _tokenized(b"".join(kinds), mode)
    return out


#: the names of :func:`cases`, in its order
NAMES = ("text, a tail block of 777 bytes", "an empty shard", "one block of 5 bytes",
         "one block of 12 bytes", "one block of 13 bytes", "one block of 255 bytes",
         "noise: every block raw", "zeros: runs to the limit", "a period of two",
         "backward extension into literals", "candidates at or after their position",
         "lengths past the scan and past the bytes", "every kind side by side")


#: the chain depths of the HC cases' tables: the least an HC level walks,
#: level 6's, and the cap (level 7 and up; the most the match finder takes)
HC_DEPTHS = (8, 32, 64)


def _planted(rng, n: int, lengths, near: bool) -> bytes:
    """Noise with copies of earlier bytes planted at random, ``lengths``
    long.  With ``near`` each copy at q is the match of a shorter one: a
    copy one or two bytes on, longer by one to three, and then the first
    ``lengths`` bytes at q copied back to an earlier source, so the match
    at q meets a longer one at q + 1 or q + 2."""
    data = bytearray(_noise(rng, n))
    for _ in range(n // 60):
        L = int(rng.integers(*lengths))
        q = int(rng.integers(2 * L + 200, n - 2 * L - 8))
        src = int(rng.integers(0, q - L - 64))
        if not near:
            data[q:q + L] = data[src:src + L]
            continue
        step, more = int(rng.integers(1, 3)), int(rng.integers(1, 4))
        data[q + step:q + step + L + more] = data[src:src + L + more]
        back = int(rng.integers(0, q - L - 64))
        data[back:back + L] = data[q:q + L]
    return bytes(data)


@functools.cache
def hc_cases(mode: str) -> dict:
    """The shards of the HC parse in wire format ``mode``, by name: their
    tables from ``tokenize_plain`` at an HC level's comparison
    (``lz4_torch.HC_CAPJ``) and each of :data:`HC_DEPTHS`."""
    from . import lz4_torch

    rng = np.random.default_rng(26)
    capj = lz4_torch.HC_CAPJ[mode]
    text = _text(rng, 3 * B + 501)
    near = _planted(rng, 2 * B + 333, (4, 24), True)
    out = {}
    for d in HC_DEPTHS:
        out[f"text at depth {d}"] = _tokenized(text, mode, d, capj)
        out[f"planted repeats at depth {d}"] = _tokenized(near, mode, d, capj)
    out["lengths about the lazy cap"] = _tokenized(
        _planted(rng, 2 * B, (30, 42), True), mode, 32, capj)
    out["lone repeats"] = _tokenized(_planted(rng, B + 99, (4, 60), False), mode, 32, capj)
    return out


#: the names of :func:`hc_cases`, in its order
HC_NAMES = tuple(f"{kind} at depth {d}" for d in HC_DEPTHS
                 for kind in ("text", "planted repeats")) + (
    "lengths about the lazy cap", "lone repeats")
