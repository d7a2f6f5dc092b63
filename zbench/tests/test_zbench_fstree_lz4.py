"""The LZ4 tree's cell (``fstree-lz4.roundtrip``) and the counts an LZ4
entry (``zbench/per_entry.py`` and the readers of
``create.lz4_ms_per_entry``, ``extract.lz4_ms_per_read``,
``create.launches_per_entry``, ``create.waits_per_entry`` and
``codec.device_entries_pct.extract``) on synthetic windows, with parents,
without them and with nothing to read; and small runs on the CPU: the
cell traced and untraced, each ``correct``, its control, which is not,
and the Silesia LZ4 cell traced, where the create readers read."""

import time

import pytest

from zbench import control, harness
from zbench.harness import Cell, Op, Window
from zpack_tpu_torch import engine

CELL = "fstree-lz4.roundtrip"
SILESIA = "silesia-lz4.roundtrip"
NEW = ["create.lz4_ms_per_entry", "extract.lz4_ms_per_read", "create.launches_per_entry",
       "create.waits_per_entry", "codec.device_entries_pct.extract"]
#: at this scale the tree's 10 largest files keep 64 KiB or more, so both
#: routes run on create and on read
SCALE = 0.012


def _c(calls, parents, seconds=0.0):
    return {"calls": calls, "seconds": seconds, "bytes": 0, "MBps": 0.0,
            "self_seconds": seconds, "parents": parents}


def _window():
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.0, input_bytes=2_000_000)
    w.ops = [Op("create", 0.0, 0.5, 2_000_000, 1_000_000),
             Op("read", 0.5, 1.0, 100, 1_000_000, "a", True, 0),
             Op("read", 1.0, 1.5, 100, 1_000_000, "b", True, 0)]
    w.counters = {
        "writer.write_archive": _c(1, {"": 1}, 0.5),
        # one of the five compress calls outside any create
        "lz4.compress": _c(5, {"writer.write_archive": 4, "": 1}, 0.05),
        "lz4.compress.device": _c(2, {"lz4.compress": 2}),
        "lz4.compress.host": _c(3, {"lz4.compress": 3}),
        "torch.dispatch": _c(3, {"lz4.compress": 3}),
        "launch.lz4_tokenize": _c(3, {"torch.dispatch": 3}),
        "torch.d2h": _c(3, {"lz4.compress": 3}),
        "torch.d2h.wait": _c(3, {"torch.d2h": 3}),
        "reader.read_file": _c(4, {"": 4}, 0.9),
        "lz4.decompress": _c(4, {"reader.read_file": 4}, 0.02),
        "lz4.decompress.device": _c(1, {"lz4.decompress": 1}),
        "lz4.decompress.host": _c(3, {"lz4.decompress": 3}),
        "launch.lz4_parse": _c(1, {"lz4.decompress": 1}),
        # a launch on a thread of its own, with no phase open
        "launch.xxh3_batch": _c(2, {"": 2}),
    }
    return w


def _read(name, w):
    return harness._reader("metrics", name)(w)


def test_counts_an_entry_follow_the_parents():
    got = {n: _read(n, _window()) for n in NEW}
    # 4 of the 5 compress calls, and their seconds, inside the create
    assert got["create.lz4_ms_per_entry"] == pytest.approx(1e3 * 0.05 * 4 / 5 / 4)
    assert got["extract.lz4_ms_per_read"] == pytest.approx(1e3 * 0.02 / 4)
    # 3 launches and 3 waits under lz4.compress, 4/5 of them in the create,
    # over the device-routed entries there (2 x 4/5)
    assert got["create.launches_per_entry"] == pytest.approx(3 / 2)
    assert got["create.waits_per_entry"] == pytest.approx(3 / 2)
    assert got["codec.device_entries_pct.extract"] == pytest.approx(25.0)


def test_counts_an_entry_without_routes_or_parents():
    w = _window()
    # a program that counts no route (the parent of the counts)
    w.counters = {k: v for k, v in w.counters.items()
                  if not k.startswith(("lz4.compress.", "lz4.decompress."))}
    assert _read("create.launches_per_entry", w) is None
    assert _read("create.waits_per_entry", w) is None
    assert _read("codec.device_entries_pct.extract", w) is None
    assert _read("create.lz4_ms_per_entry", w) == pytest.approx(1e3 * 0.05 / 5)
    # a program that counts no launch (the CPU routes)
    w = _window()
    w.counters = {k: v for k, v in w.counters.items() if not k.startswith("launch.")}
    assert _read("create.launches_per_entry", w) is None
    assert _read("create.waits_per_entry", w) == pytest.approx(3 / 2)
    # a program that records no parents
    w.counters = {k: {kk: vv for kk, vv in v.items() if kk != "parents"}
                  for k, v in _window().counters.items()}
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)


def test_counts_an_entry_with_nothing_to_read():
    w = _window()
    w.counters = {}
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)
    # entries, but none on the device route, and no create or read
    w = _window()
    w.counters["lz4.compress.device"] = _c(0, {})
    assert _read("create.launches_per_entry", w) is None
    w = _window()
    for root in ("writer.write_archive", "reader.read_file"):
        del w.counters[root]
    assert {n: _read(n, w) for n in NEW} == dict.fromkeys(NEW)


def test_the_cells_read_the_new_metrics():
    """The tree reports no ``create_MBps`` (its runs spread too widely), so
    no metric that moves it; Silesia's LZ4 cell reads all five."""
    tree = harness.load_cell(CELL)
    assert "create_MBps" not in {m["name"] for m in tree.end_to_end}
    assert {m["name"] for m in tree.per_layer} & set(NEW) == {
        "extract.lz4_ms_per_read", "codec.device_entries_pct.extract"}
    assert {m["name"] for m in harness.load_cell(SILESIA).per_layer} >= set(NEW)


def _run(trace, seed, cell=CELL, scale=SCALE):
    try:
        result, lines = harness.run(cell, seed, 2.0, trace, t_start=time.perf_counter(),
                                    device="cpu", scale=scale)
    finally:
        engine.uninstall()
    assert result is not None and len(lines) == len(result["checks"])
    return result


def test_traced_run_of_the_lz4_tree_is_correct():
    result = _run(True, 2**31 + 97)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    metrics = result["metrics"]
    # the entries that keep 64 KiB at this scale take the device route
    members = harness.load_cell(CELL).config["members"]
    device = sum(max(1, int(m["bytes"] * SCALE)) >= 64 << 10 for m in members)
    assert device == 10
    assert metrics["codec.device_entries_pct.extract"]["value"] == pytest.approx(
        100 * device / len(members))
    assert metrics["extract.lz4_ms_per_read"]["value"] > 0


def test_traced_run_of_silesia_lz4_reads_the_create_counts():
    # at this scale mozilla alone keeps 64 KiB, the device route's floor
    result = _run(True, 2**31 + 97, SILESIA, 0.0015)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["codec.device_entries_pct.extract"]["value"] == pytest.approx(100 / 12)
    # the CPU route waits once an entry (the tables' download) and launches
    # no hand-written kernel, so the launches read nothing here
    assert metrics["create.waits_per_entry"]["value"] == pytest.approx(1.0)
    assert "create.launches_per_entry" not in metrics
    for name in ("create.lz4_ms_per_entry", "extract.lz4_ms_per_read"):
        assert metrics[name]["value"] > 0, name


def test_sound_run_of_the_lz4_tree_reports_its_end_to_end_metrics():
    result = _run(False, 2**31 + 99)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(CELL).end_to_end}


def test_control_of_the_lz4_tree_is_not_correct():
    undo = control.install()
    try:
        result = _run(False, 2**31 + 99)
    finally:
        undo()
    assert not result["correct"]
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["archive_faults"] > 0 and checks["blocks_wrong"] > 0
    assert checks["read_faults"] > 0
