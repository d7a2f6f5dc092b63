"""Shared pieces of the corpus generators: a token stream drawn from a
vocabulary by a Zipf-like law, assembled without a loop over tokens.

Every generator is a module ``zbench/gen/<kind>.py`` with
``generate(rng, size, params, shape) -> np.ndarray`` (uint8, exactly
``size`` bytes).  ``shape`` draws what makes the member what it is (its
vocabulary, its tables), the same for every seed; ``rng`` draws the
content from ``--seed``.  So every seed gets a member of the same kind and
compressibility, in other bytes.  Only numpy is used, in chunks of a few MiB, so a 50 MB member takes
a fraction of a second and bounded memory.
"""

from __future__ import annotations

import numpy as np

#: bytes assembled a pass: bounds the index arrays to a few tens of MB
CHUNK = 4 << 20

#: relative frequencies of a to z in English prose
LETTER_FREQ = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.2, 0.8, 4.0, 2.4,
                        6.7, 7.5, 1.9, 0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.2, 2.0, 0.1])


class Vocab:
    """Tokens as one flat byte array with offsets and lengths."""

    def __init__(self, tokens: list[bytes]):
        self.lens = np.array([len(t) for t in tokens], dtype=np.int64)
        self.offs = np.concatenate([[0], np.cumsum(self.lens)[:-1]]).astype(np.int64)
        self.flat = np.frombuffer(b"".join(tokens), dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.lens)


def words(rng: np.random.Generator, n: int, mean_len: float = 5.0) -> list[bytes]:
    """``n`` distinct-ish lowercase words, lengths about ``mean_len``."""
    lens = np.clip(rng.poisson(mean_len - 1, n) + 1, 1, 16)
    p = LETTER_FREQ / LETTER_FREQ.sum()
    letters = (rng.choice(26, size=int(lens.sum()), p=p) + ord("a")).astype(np.uint8)
    raw = letters.tobytes()
    out, pos = [], 0
    for k in lens.tolist():
        out.append(raw[pos:pos + k])
        pos += k
    return out


def zipf_ranks(rng: np.random.Generator, n: int, v: int, skew: float = 1.0) -> np.ndarray:
    """``n`` ranks in ``[0, v)`` with P(rank k) falling about as 1/(k+1)^skew
    (log-uniform for skew 1): the inverse of the continuous power law."""
    u = rng.random(n)
    if skew == 1.0:
        r = np.exp(u * np.log(v + 1.0)) - 1.0
    else:
        a = 1.0 - skew
        r = ((v + 1.0) ** a * u + (1.0 - u)) ** (1.0 / a) - 1.0
    return np.minimum(r.astype(np.int64), v - 1)


def token_stream(rng: np.random.Generator, size: int, vocab: Vocab,
                 skew: float = 1.0) -> np.ndarray:
    """``size`` bytes of tokens drawn by :func:`zipf_ranks`, back to back:
    the drawn rows of a padded token table, compressed by a length mask."""
    width = int(vocab.lens.max())
    mask = np.arange(width)[None, :] < vocab.lens[:, None]
    table = np.zeros((len(vocab), width), dtype=np.uint8)
    table[mask] = vocab.flat
    mean = max(1.0, float(vocab.lens.mean()))
    out = np.empty(size, dtype=np.uint8)
    filled = 0
    while filled < size:
        want = min(CHUNK, size - filled)
        idx = zipf_ranks(rng, int(want / mean * 1.1) + 16, len(vocab), skew)
        piece = table[idx][mask[idx]]
        take = min(len(piece), want)
        out[filled:filled + take] = piece[:take]
        filled += take
    return out


def overwrite_segments(rng: np.random.Generator, buf: np.ndarray, share: float,
                       mean_len: int, fill: str) -> None:
    """Overwrite about ``share`` of ``buf`` with segments of mean length
    ``mean_len``, each random bytes (``fill="random"``) or zeros."""
    n = len(buf)
    count = int(n * share / mean_len)
    if count == 0:
        return
    starts = rng.integers(0, n, count)
    lens = np.maximum(1, rng.exponential(mean_len, count).astype(np.int64))
    noise = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8) if fill == "random" else None
    pos = 0
    for s, k in zip(starts.tolist(), lens.tolist()):
        e = min(n, s + k)
        if noise is None:
            buf[s:e] = 0
        else:
            buf[s:e] = noise[pos:pos + e - s]
        pos += k
