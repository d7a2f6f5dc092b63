"""Prose and markup: words from a Zipf-ranked vocabulary, each with its
punctuation, (``markup`` > 0) tags among the most frequent tokens, and
phrases of those tokens among them: the repeated word sequences of real
prose and markup, which words drawn one by one lack.  The phrases set the
corpus's compressibility: with them the Silesia configurations store 47.9%
at LZ4 level 1, against the 47.6% (ratio 2.101) the LZ4 README gives for
the real corpus."""

from __future__ import annotations

import numpy as np

from .common import Vocab, token_stream, words, zipf_ranks

SEPARATORS = [b" "] * 12 + [b", ", b". ", b"\n", b"; ", b" - ", b".\n\n"]
#: phrases in the vocabulary, each of 2 to PHRASE_WORDS tokens
PHRASES = 1000
PHRASE_WORDS = 5


def vocabulary(rng: np.random.Generator, params: dict) -> Vocab:
    n = int(params.get("vocab", 30000))
    ws = words(rng, n, float(params.get("mean_len", 5.0)))
    seps = rng.integers(0, len(SEPARATORS), n)
    caps = rng.random(n) < float(params.get("capitals", 0.1))
    tokens = [(w.capitalize() if c else w) + SEPARATORS[s]
              for w, s, c in zip(ws, seps.tolist(), caps.tolist())]
    tags = int(params.get("markup", 0))
    if tags:
        names = words(rng, tags, 4.0)
        marks = []
        for i, name in enumerate(names):
            attr = b' class="' + names[(i * 7 + 3) % tags] + b'"' if i % 3 == 0 else b""
            marks += [b"<" + name + attr + b">", b"</" + name + b">\n"]
        # tags take every fourth of the top ranks
        for i, m in enumerate(marks):
            tokens.insert(min(len(tokens), 4 * i), m)
    counts = rng.integers(2, PHRASE_WORDS + 1, PHRASES)
    picks = zipf_ranks(rng, int(counts.sum()), len(tokens)).tolist()
    ends = np.cumsum(counts).tolist()
    made = [b"".join(tokens[k] for k in picks[e - c:e]) for c, e in zip(counts.tolist(), ends)]
    # phrases take every other one of the top ranks
    for i, ph in enumerate(made):
        tokens.insert(min(len(tokens), 2 * i + 1), ph)
    return Vocab(tokens)


def generate(rng: np.random.Generator, size: int, params: dict,
             shape: np.random.Generator) -> np.ndarray:
    return token_stream(rng, size, vocabulary(shape, params), float(params.get("skew", 1.0)))
