"""Medical and X-ray images: square frames of smooth anatomy-like fields
plus sensor noise, inside a disc on a dark background (``background`` > 0),
quantised to ``bits`` bits and stored little-endian in 1 or 2 bytes."""

from __future__ import annotations

import numpy as np


def generate(rng: np.random.Generator, size: int, params: dict,
             shape: np.random.Generator) -> np.ndarray:
    bits = int(params.get("bits", 16))
    width = int(params.get("width", 512))
    noise = float(params.get("noise", 0.02))
    background = bool(params.get("background", 1))
    nbytes = 2 if bits > 8 else 1
    per = width * width * nbytes
    top = (1 << bits) - 1
    y, x = np.mgrid[0:width, 0:width].astype(np.float32) / width
    disc = ((x - 0.5) ** 2 + (y - 0.5) ** 2) < 0.2 if background else np.ones_like(x, bool)
    out = np.empty(size, dtype=np.uint8)
    filled = 0
    while filled < size:
        f = rng.uniform(2.0, 9.0, 4).astype(np.float32)
        ph = rng.uniform(0, 6.28, 4).astype(np.float32)
        field = (0.5 + 0.2 * np.sin(f[0] * x + ph[0]) * np.cos(f[1] * y + ph[1])
                 + 0.1 * np.sin(f[2] * (x + y) + ph[2]) + 0.1 * np.cos(f[3] * x * y + ph[3]))
        field += rng.standard_normal(field.shape, dtype=np.float32) * noise
        img = np.clip(field, 0, 1) * top
        img[~disc] = 0
        frame = img.astype("<u2" if nbytes == 2 else np.uint8).tobytes()
        take = min(per, size - filled)
        out[filled:filled + take] = np.frombuffer(frame, dtype=np.uint8, count=take)
        filled += take
    return out
