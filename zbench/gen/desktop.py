"""The files of a desktop directory tree: one generator for every member of
a file-tree configuration, the member's content kind named by
``params["content"]`` (:data:`CONTENTS`).

The kinds reuse the pieces of the Silesia kinds (``text``, ``records``,
``binary``), but build each kind's vocabulary and tables once a process,
from a stream fixed for every seed and every member, where those rebuild
them on every call: a tree has thousands of members, most of them a few
KB, and a 30,000-word vocabulary built a member would take minutes.  Each
member's bytes are then drawn from its own stream (``rng``, from
``--seed`` and the member), so they depend on the seed and the member
alone; ``shape`` is not used."""

from __future__ import annotations

import threading

import numpy as np

from . import binary, records, text
from .common import CHUNK, Vocab, overwrite_segments, zipf_ranks

#: the seed of every content kind's vocabulary and tables
SHAPE_SEED = 20090224

#: content kind: (the Silesia kind whose pieces it uses, its parameters):
#: text takes dickens' parameters, markup samba's (source code), binary
#: mozilla's (executables and libraries), as ``zbench/configs/silesia-*``
#: set them; records are comma-separated rows of five fields, assumed.
#: "media" stands for already-compressed files (JPEG, GIF, ZIP): every
#: byte random, which is what ``random_share`` 1.0 means of a file (the
#: binary kind's random segments, placed at random, cover about 1 - 1/e of
#: it at that share and leave a file zstd-3 stores at about 83%)
CONTENTS = {
    "text": ("text", {"vocab": 30000, "mean_len": 4.5}),
    "markup": ("text", {"vocab": 6000, "mean_len": 5.0, "skew": 1.1, "markup": 20}),
    "records": ("records", {"columns": [
        ["seq", 8, 1], ["const", 0, ","], ["enum", 12, 400], ["const", 0, ","],
        ["num", 10, 2], ["const", 0, ","], ["num", 7, 0], ["const", 0, ","],
        ["enum", 8, 30], ["const", 0, "\n"]]}),
    "binary": ("binary", {"vocab": 16384, "max_len": 8, "random_share": 0.1,
                          "zero_share": 0.08}),
    "media": ("random", {}),
}

_built: dict = {}
_lock = threading.Lock()


class _Tokens:
    """A vocabulary as the padded table ``common.token_stream`` draws rows
    of, built once."""

    def __init__(self, vocab: Vocab, skew: float):
        width = int(vocab.lens.max())
        self.mask = np.arange(width)[None, :] < vocab.lens[:, None]
        self.table = np.zeros((len(vocab), width), dtype=np.uint8)
        self.table[self.mask] = vocab.flat
        self.mean = max(1.0, float(vocab.lens.mean()))
        self.skew = skew

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``size`` bytes of tokens, as ``common.token_stream`` draws them."""
        out = np.empty(size, dtype=np.uint8)
        filled = 0
        while filled < size:
            want = min(CHUNK, size - filled)
            idx = zipf_ranks(rng, int(want / self.mean * 1.1) + 16, len(self.table), self.skew)
            piece = self.table[idx][self.mask[idx]]
            take = min(len(piece), want)
            out[filled:filled + take] = piece[:take]
            filled += take
        return out


def _binary_vocab(shape: np.random.Generator, params: dict) -> Vocab:
    """The vocabulary ``binary.generate`` builds: instruction-like tokens."""
    n = int(params["vocab"])
    lens = shape.integers(1, int(params["max_len"]) + 1, n)
    raw = shape.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    raw[starts] = shape.choice(np.arange(256, dtype=np.uint8), size=n,
                               p=binary._skewed(shape, 256))
    return Vocab([raw[s:s + k].tobytes() for s, k in zip(starts.tolist(), lens.tolist())])


def _build(content: str):
    base, params = CONTENTS[content]
    shape = np.random.default_rng([SHAPE_SEED, list(CONTENTS).index(content)])
    if base == "text":
        return _Tokens(text.vocabulary(shape, params), float(params.get("skew", 1.0)))
    if base == "binary":
        return _Tokens(_binary_vocab(shape, params), 1.1)
    columns = [tuple(c) for c in params["columns"]]
    return {i: records._table(shape, w, a) for i, (k, w, a) in enumerate(columns) if k == "enum"}


def built(content: str):
    """The content kind's vocabulary or tables, built on first use."""
    got = _built.get(content)
    if got is None:
        with _lock:
            got = _built.get(content)
            if got is None:
                got = _built[content] = _build(content)
    return got


def _records(rng: np.random.Generator, size: int, columns, tables) -> np.ndarray:
    """``records.generate``'s rows, with the tables given."""
    row_w = sum(records._column(rng, 1, 0, k, w, a, tables.get(i)).shape[1]
                for i, (k, w, a) in enumerate(columns))
    out = np.empty(size, dtype=np.uint8)
    filled = base = 0
    while filled < size:
        rows = max(1, min(1 << 16, (size - filled) // row_w + 1))
        block = np.concatenate([records._column(rng, rows, base, k, w, a, tables.get(i))
                                for i, (k, w, a) in enumerate(columns)], axis=1).reshape(-1)
        take = min(len(block), size - filled)
        out[filled:filled + take] = block[:take]
        filled += take
        base += rows
    return out


def generate(rng: np.random.Generator, size: int, params: dict,
             shape: np.random.Generator) -> np.ndarray:
    content = params["content"]
    base, kind = CONTENTS[content]
    if base == "random":
        return rng.integers(0, 256, size, dtype=np.uint8)
    made = built(content)
    if base == "records":
        return _records(rng, size, [tuple(c) for c in kind["columns"]], made)
    out = made.draw(rng, size)
    if base == "binary":
        overwrite_segments(rng, out, kind["random_share"], 2048, "random")
        overwrite_segments(rng, out, kind["zero_share"], 1024, "zeros")
    return out
