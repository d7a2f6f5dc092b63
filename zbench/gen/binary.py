"""Executables and libraries: instruction-like byte strings from a
Zipf-ranked vocabulary, with runs of random bytes (constants, compressed
resources) and of zeros (padding) written over it."""

from __future__ import annotations

import numpy as np

from .common import Vocab, overwrite_segments, token_stream


def generate(rng: np.random.Generator, size: int, params: dict,
             shape: np.random.Generator) -> np.ndarray:
    n = int(params.get("vocab", 8192))
    lens = shape.integers(1, int(params.get("max_len", 8)) + 1, n)
    # opcode-like first bytes from a small skewed set, operands random
    raw = shape.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    raw[starts] = shape.choice(np.arange(256, dtype=np.uint8), size=n,
                               p=_skewed(shape, 256))
    tokens = [raw[s:s + k].tobytes() for s, k in zip(starts.tolist(), lens.tolist())]
    out = token_stream(rng, size, Vocab(tokens), float(params.get("skew", 1.1)))
    overwrite_segments(rng, out, float(params.get("random_share", 0.15)), 2048, "random")
    overwrite_segments(rng, out, float(params.get("zero_share", 0.05)), 1024, "zeros")
    return out


def _skewed(rng: np.random.Generator, k: int) -> np.ndarray:
    w = 1.0 / (1.0 + rng.permutation(k))
    return w / w.sum()
