"""The cell's members, made from ``--seed`` by the generator of each
member's kind (``zbench/gen/<kind>.py``) at the member's size."""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: the seed of every member's vocabulary and tables
SHAPE_SEED = 211938580


def member_rng(seed: int, index: int) -> np.random.Generator:
    """The content stream of member ``index``: any whole seed, large or
    negative."""
    return np.random.default_rng([seed % (1 << 64), index])


def shape_rng(index: int) -> np.random.Generator:
    """The stream of member ``index``'s vocabulary and tables, the same for
    every seed."""
    return np.random.default_rng([SHAPE_SEED, index])


def member(config: dict, seed: int, index: int, scale: float = 1.0) -> bytes:
    m = config["members"][index]
    size = max(1, int(m["bytes"] * scale))
    gen = importlib.import_module(f"zbench.gen.{m['kind']}")
    data = gen.generate(member_rng(seed, index), size, m.get("params", {}), shape_rng(index))
    if data.dtype != np.uint8 or data.shape != (size,):
        raise ValueError(f"generator {m['kind']} gave {data.dtype} {data.shape} for {size}")
    return data.tobytes()


def build(config: dict, seed: int, scale: float = 1.0,
          workers: int = 1) -> list[tuple[str, bytes]]:
    """``(name, bytes)`` a member, in the configuration's order, made on
    ``workers`` threads (numpy releases the interpreter lock; each member
    has its own stream, so the bytes do not depend on the threads).
    ``scale`` shrinks every member (tests only; runs use 1)."""
    idx = range(len(config["members"]))
    with ThreadPoolExecutor(workers) as pool:
        datas = list(pool.map(lambda i: member(config, seed, i, scale), idx))
    return [(m["name"], d) for m, d in zip(config["members"], datas)]
