"""The corpus: each member at its published size, the same bytes from the
same seed, other bytes from another."""

import json

import numpy as np
import pytest

from zbench import corpus
from zbench.harness import HERE

CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))
SILESIA_BYTES = 211_938_580


@pytest.mark.parametrize("name", CONFIGS)
def test_published_sizes(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert len(cfg["members"]) == 12
    assert sum(m["bytes"] for m in cfg["members"]) == SILESIA_BYTES
    assert cfg["reduced"] == []


@pytest.mark.parametrize("name", CONFIGS)
def test_members_repeat_from_seed(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    a = corpus.build(cfg, 2**31 + 5, scale=0.001, workers=3)
    b = corpus.build(cfg, 2**31 + 5, scale=0.001, workers=1)
    c = corpus.build(cfg, 2**31 + 6, scale=0.001)
    assert a == b
    assert [n for n, _ in a] == [m["name"] for m in cfg["members"]]
    for (_, x), (_, y), m in zip(a, c, cfg["members"]):
        assert len(x) == max(1, int(m["bytes"] * 0.001))
        assert x != y


@pytest.mark.parametrize("kind", ["text", "binary", "image", "records"])
def test_generator_gives_exact_size(kind):
    import importlib

    cfg = json.loads((HERE / "configs" / "silesia-lz4.json").read_text())
    params = next(m["params"] for m in cfg["members"] if m["kind"] == kind)
    gen = importlib.import_module(f"zbench.gen.{kind}")
    for size in (1, 777, 70_001):
        out = gen.generate(np.random.default_rng(3), size, params, np.random.default_rng(4))
        assert out.dtype == np.uint8 and out.shape == (size,)


def test_full_size_member_is_published_size():
    cfg = json.loads((HERE / "configs" / "silesia-lz4.json").read_text())
    i = [m["name"] for m in cfg["members"]].index("xml")
    assert len(corpus.member(cfg, 11, i)) == 5_345_280
