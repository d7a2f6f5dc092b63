"""The reader of `extract.zstd_native_walk_pct` on synthetic windows: the
share of zstd walks that ran the native walk."""

import pytest

from zbench.harness import Cell, Window, _reader


def _window(counters):
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.0)
    w.counters = counters
    return w


def _walk(calls):
    return {"calls": calls, "seconds": 0.1 * calls, "bytes": 0}


def test_reads_zero_without_the_native_span_and_100_with_it():
    read = _reader("metrics", "extract.zstd_native_walk_pct")
    assert read(_window({"torch.zstd_walk": _walk(12)})) == 0.0
    assert read(_window({"torch.zstd_walk": _walk(12),
                         "torch.zstd_walk.native": _walk(12)})) == 100.0
    assert read(_window({"torch.zstd_walk": _walk(4),
                         "torch.zstd_walk.native": _walk(3)})) == pytest.approx(75.0)


def test_reads_nothing_where_no_zstd_walk_ran():
    read = _reader("metrics", "extract.zstd_native_walk_pct")
    assert read(_window({})) is None
    assert read(_window({"lz4.decompress": _walk(3)})) is None
