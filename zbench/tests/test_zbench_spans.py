"""The readers of the program's own spans: each on a synthetic window whose
counters carry parents and self time, on counters without them (a program
that records none, which they must read as nothing), and in a small traced
run of each cell on the CPU."""

import time

import pytest

from zbench import harness, spans
from zbench.harness import Cell, Op, Window
from zpack_tpu_torch import engine

NEW = ["archive.writer_ms_per_MB.create", "archive.reader_ms_per_MB.extract",
       "archive.xxh3_ms_per_MB.create", "archive.xxh3_ms_per_MB.extract",
       "pipeline.host_copies_ms_per_MB", "extract.zstd_huffman_tables_ms_per_MB",
       "extract.zstd_fse_tables_ms_per_MB", "device.wait_ms_per_MB.create",
       "device.wait_ms_per_MB.extract"]


def _c(seconds, parents, calls=None):
    calls = calls or sum(parents.values())
    return {"calls": calls, "seconds": seconds, "bytes": 0, "MBps": 0.0,
            "self_seconds": seconds, "parents": parents}


def _window():
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.0, input_bytes=4_000_000)
    # one create of 4 MB and two reads of 1 MB each
    w.ops = [Op("create", 0.0, 1.0, 4_000_000, 2_000_000),
             Op("read", 1.0, 1.5, 100, 1_000_000, "a", True, 0),
             Op("read", 1.5, 2.0, 100, 1_000_000, "b", True, 0)]
    w.counters = {
        "writer.write_archive": _c(0.8, {"": 1}),
        "writer.buffer": _c(0.04, {"": 1}),
        "writer.xxh3": _c(0.02, {"writer.write_archive": 2}),
        "lz4.compress": _c(0.6, {"writer.write_archive": 2}),
        "torch.stage": _c(0.01, {"lz4.compress": 2}),
        "torch.frame": _c(0.03, {"lz4.compress": 6}),
        "torch.d2h": _c(0.1, {"lz4.compress": 2}),
        "torch.d2h.wait": _c(0.08, {"torch.d2h": 2}),
        "reader.open": _c(0.01, {"": 1}),
        "reader.read_file": _c(0.9, {"": 2}),
        "reader.xxh3": _c(0.004, {"reader.read_file": 2}),
        # one of the two decompress calls outside any read
        "zstd.decompress": _c(0.8, {"reader.read_file": 1, "": 1}),
        "torch.zstd_walk": _c(0.5, {"zstd.decompress": 2}),
        "torch.zstd_walk.literals": _c(0.2, {"torch.zstd_walk": 20}),
        "torch.zstd_walk.sequences": _c(0.1, {"torch.zstd_walk": 20}),
        "torch.replay": _c(0.1, {"zstd.decompress": 2}),
        "torch.replay.wait": _c(0.06, {"torch.replay": 4}),
    }
    return w


def _read(name, w):
    return harness._reader("metrics", name)(w)


def test_share_under_follows_the_chain_of_parents():
    c = _window().counters
    assert spans.share_under(c, "torch.replay.wait", "reader.read_file") == pytest.approx(0.5)
    assert spans.share_under(c, "torch.d2h.wait", "writer.write_archive") == 1.0
    assert spans.share_under(c, "torch.d2h.wait", "reader.read_file") == 0.0
    assert spans.share_under(c, "missing", "reader.read_file") == 0.0
    # a loop in the parents ends the walk
    loop = {"a": _c(1.0, {"b": 1}), "b": _c(1.0, {"a": 1})}
    assert spans.share_under(loop, "a", "root") == 0.0


def test_readers_on_a_window_with_parents():
    w = _window()
    got = {n: _read(n, w) for n in NEW}
    # (0.8 - 0.6 + 0.04) s over 4 MB
    assert got["archive.writer_ms_per_MB.create"] == pytest.approx(60.0)
    # (0.9 - 0.8 / 2 + 0.01) s over 2 MB
    assert got["archive.reader_ms_per_MB.extract"] == pytest.approx(255.0)
    assert got["archive.xxh3_ms_per_MB.create"] == pytest.approx(5.0)
    assert got["archive.xxh3_ms_per_MB.extract"] == pytest.approx(2.0)
    assert got["pipeline.host_copies_ms_per_MB"] == pytest.approx(10.0)
    assert got["extract.zstd_huffman_tables_ms_per_MB"] == pytest.approx(100.0)
    assert got["extract.zstd_fse_tables_ms_per_MB"] == pytest.approx(50.0)
    assert got["device.wait_ms_per_MB.create"] == pytest.approx(20.0)
    # half the replay's waits are inside a read
    assert got["device.wait_ms_per_MB.extract"] == pytest.approx(15.0)


def test_readers_read_nothing_without_the_spans():
    w = _window()
    # a program that records neither the new spans nor parents
    w.counters = {k: {kk: vv for kk, vv in v.items() if kk not in ("self_seconds", "parents")}
                  for k, v in w.counters.items()
                  if not k.startswith(("writer.", "reader.", "torch.stage", "torch.frame"))
                  and not k.endswith((".wait", ".literals", ".sequences"))}
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)
    w.counters = {}
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)


SCALE = {"silesia-lz4.roundtrip": 0.0015, "silesia-zstd3.extract": 0.0004}


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_traced_run_reports_the_new_metrics(cell):
    try:
        result, _ = harness.run(cell, 2**31 + 97, 3.0, True, t_start=time.perf_counter(),
                                device="cpu", scale=SCALE[cell])
    finally:
        engine.uninstall()
    assert result["correct"], result["checks"]
    want = {m["name"] for m in harness.load_cell(cell).per_layer if m["name"] in NEW}
    assert want and want <= set(result["metrics"])
    for name in want:
        assert result["metrics"][name]["value"] >= 0, name
    # the trace names the new spans among the card's idle time
    gaps = [k for k, _ in result["breakdown"]["idle_gaps"]]
    assert any(k.startswith(("reader.", "writer.", "torch.stage", "torch.frame"))
               or k.endswith((".wait", ".literals", ".sequences")) for k in gaps), gaps
