"""The counts a read (``zbench/per_read.py`` and the readers of
``extract.launches_per_read``, ``extract.waits_per_read`` and
``extract.zstd_ms_per_read``) on synthetic windows, with parents, without
them and with nothing to read; and a small traced run of
``fstree-zstd3.extract`` on the CPU that ends ``correct``."""

import time

import pytest

from zbench import harness
from zbench.harness import Cell, Op, Window
from zpack_tpu_torch import engine

NEW = ["extract.launches_per_read", "extract.waits_per_read", "extract.zstd_ms_per_read"]


def _c(calls, parents, seconds=0.0):
    return {"calls": calls, "seconds": seconds, "bytes": 0, "MBps": 0.0,
            "self_seconds": seconds, "parents": parents}


def _window():
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.0, input_bytes=2_000_000)
    w.ops = [Op("read", 0.0, 0.5, 100, 1_000_000, "a", True, 0),
             Op("read", 0.5, 1.0, 100, 1_000_000, "b", True, 0)]
    w.counters = {
        "reader.read_file": _c(4, {"": 4}, 0.9),
        # one of the five decompress calls outside any read
        "zstd.decompress": _c(5, {"reader.read_file": 4, "": 1}, 0.5),
        "torch.huffman_decode": _c(5, {"zstd.decompress": 5}),
        "torch.huffman_decode.wait": _c(10, {"torch.huffman_decode": 10}),
        "torch.replay": _c(5, {"zstd.decompress": 5}),
        "torch.replay.wait": _c(10, {"torch.replay": 10}),
        "torch.d2h.wait": _c(3, {"torch.d2h": 3}),
        "launch.huffman_decode": _c(5, {"torch.huffman_decode": 5}),
        "launch.lz4_replay": _c(5, {"torch.replay": 5}),
        # a launch on a thread of its own, with no phase open
        "launch.xxh3_batch": _c(2, {"": 2}),
    }
    return w


def _read(name, w):
    return harness._reader("metrics", name)(w)


def test_counts_a_read_follow_the_parents():
    got = {n: _read(n, _window()) for n in NEW}
    # 10 launches under zstd.decompress, 4 of its 5 calls inside the 4 reads
    assert got["extract.launches_per_read"] == pytest.approx(8 / 4)
    # 20 waits under zstd.decompress likewise; torch.d2h is in no read
    assert got["extract.waits_per_read"] == pytest.approx(16 / 4)
    assert got["extract.zstd_ms_per_read"] == pytest.approx(100.0)


def test_counts_a_read_without_parents_or_launches():
    w = _window()
    # a program that counts no launch (the parent of the counters, or the
    # CPU routes, which launch no hand-written kernel)
    w.counters = {k: v for k, v in w.counters.items() if not k.startswith("launch.")}
    assert _read("extract.launches_per_read", w) is None
    assert _read("extract.waits_per_read", w) == pytest.approx(4.0)
    # a program that records no parents
    w.counters = {k: {kk: vv for kk, vv in v.items() if kk != "parents"}
                  for k, v in _window().counters.items()}
    assert _read("extract.launches_per_read", w) is None
    assert _read("extract.waits_per_read", w) is None
    assert _read("extract.zstd_ms_per_read", w) == pytest.approx(100.0)


def test_counts_a_read_with_nothing_to_read():
    w = _window()
    w.counters = {}
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)
    # launches and waits but no read at all
    w = _window()
    del w.counters["reader.read_file"]
    assert _read("extract.launches_per_read", w) is None
    assert _read("extract.waits_per_read", w) is None


def test_traced_run_of_the_tree_is_correct():
    try:
        result, _ = harness.run("fstree-zstd3.extract", 2**31 + 97, 3.0, True,
                                t_start=time.perf_counter(), device="cpu", scale=0.001)
    finally:
        engine.uninstall()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    metrics = result["metrics"]
    assert metrics["codec.fallbacks.extract"]["value"] == 0
    assert metrics["extract.zstd_native_walk_pct"]["value"] == 100.0
    # every read opens waits (the entry's upload at least); the CPU routes
    # launch no hand-written kernel, so the launches read nothing here
    assert metrics["extract.waits_per_read"]["value"] >= 1
    assert metrics["extract.zstd_ms_per_read"]["value"] > 0
    assert "extract.launches_per_read" not in metrics
