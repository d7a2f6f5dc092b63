"""Fixed-width records, built a column at a time over all rows.

``params["columns"]`` lists the columns, each ``[type, width, arg]``:

* ``["const", 0, text]``: the same text in every row;
* ``["enum", width, k]``: one of ``k`` seeded words, Zipf-ranked, padded;
* ``["num", width, decimals]``: a signed decimal, right-aligned;
* ``["seq", width, step]``: the row number times ``step``, in decimal;
* ``["bin", width, bits]``: a little-endian integer of ``bits`` random bits;
* ``["seqbin", width, step]``: the row number times ``step``, little-endian.
"""

from __future__ import annotations

import numpy as np

from .common import words, zipf_ranks


def _decimal(values: np.ndarray, width: int) -> np.ndarray:
    """Right-aligned decimal text of non-negative ints, (rows, width)."""
    out = np.full((len(values), width), ord(" "), dtype=np.uint8)
    v = values.astype(np.int64).copy()
    for col in range(width - 1, -1, -1):
        digit = (v % 10).astype(np.uint8) + ord("0")
        show = (v > 0) | (col == width - 1)
        out[show, col] = digit[show]
        v //= 10
    return out


def _table(rng, width, k):
    """The ``k`` padded words of an "enum" column, (k, width)."""
    toks = words(rng, int(k), max(2.0, width / 2))
    table = np.full((len(toks), width), ord(" "), dtype=np.uint8)
    for i, t in enumerate(toks):
        table[i, :min(width, len(t))] = np.frombuffer(t[:width], dtype=np.uint8)
    return table


def _column(rng, rows, base, kind, width, arg, table=None):
    if kind == "const":
        text = np.frombuffer(str(arg).encode(), dtype=np.uint8)
        return np.broadcast_to(text, (rows, len(text)))
    if kind == "enum":
        return table[zipf_ranks(rng, rows, len(table))]
    if kind == "num":
        dec = int(arg)
        mag = (np.abs(rng.normal(0, 3.0, rows)) * 10 ** dec).astype(np.int64)
        # digits, with room for a sign and a point; at least one digit left
        # of the point
        digits = _decimal(mag, width - (1 if dec else 0))
        if dec:
            left = digits[:, :-dec]
            lead = left[:, -1] == ord(" ")
            left[lead, -1] = ord("0")
            digits = np.concatenate([left, np.full((rows, 1), ord("."), np.uint8),
                                     digits[:, -dec:]], axis=1)
            digits[:, -dec:][digits[:, -dec:] == ord(" ")] = ord("0")
        sign_at = np.argmax(digits != ord(" "), axis=1) - 1
        neg = (rng.random(rows) < 0.5) & (sign_at >= 0)
        digits[np.nonzero(neg)[0], sign_at[neg]] = ord("-")
        return digits
    if kind == "seq":
        return _decimal((base + np.arange(rows)) * int(arg), width)
    if kind == "bin":
        v = rng.integers(0, 1 << min(int(arg), 62), rows, dtype=np.int64).astype("<u8")
        return v.view(np.uint8).reshape(rows, 8)[:, :width]
    if kind == "seqbin":
        v = ((base + np.arange(rows)) * int(arg)).astype("<u8")
        return v.view(np.uint8).reshape(rows, 8)[:, :width]
    raise ValueError(f"unknown column type {kind!r}")


def generate(rng: np.random.Generator, size: int, params: dict,
             shape: np.random.Generator) -> np.ndarray:
    columns = [tuple(c) for c in params["columns"]]
    tables = {i: _table(shape, w, a) for i, (k, w, a) in enumerate(columns) if k == "enum"}
    row_w = sum(_column(rng, 1, 0, k, w, a, tables.get(i)).shape[1]
                for i, (k, w, a) in enumerate(columns))
    out = np.empty(size, dtype=np.uint8)
    filled = base = 0
    while filled < size:
        rows = max(1, min(1 << 16, (size - filled) // row_w + 1))
        block = np.concatenate([_column(rng, rows, base, k, w, a, tables.get(i))
                                for i, (k, w, a) in enumerate(columns)], axis=1).reshape(-1)
        take = min(len(block), size - filled)
        out[filled:filled + take] = block[:take]
        filled += take
        base += rows
    return out
