"""The LZ4 HC cell (``silesia-lz4hc9.roundtrip``): its configuration, the
readers of ``codec.hc_bytes_pct.create`` and
``kernels.lz4_match_ms_per_MB.create`` on synthetic windows, with and
without what they read, and small runs on the CPU: the cell traced and
untraced, each ``correct``, and its control, which is not."""

import json
import time

import pytest

from zbench import control, harness
from zbench.harness import HERE, Cell, Op, Window
from zbench.trace import Trace
from zpack_tpu_torch import engine

CELL = "silesia-lz4hc9.roundtrip"
#: at this scale mozilla alone keeps 64 KiB, the device route's floor
SCALE = 0.0015


def _read(name, w):
    return harness._reader("metrics", name)(w)


def test_configuration_is_silesia_lz4_at_level_9():
    hc = json.loads((HERE / "configs" / "silesia-lz4hc9.json").read_text())
    fast = json.loads((HERE / "configs" / "silesia-lz4.json").read_text())
    assert (hc["method"], hc["level"], hc["reduced"]) == (2, 9, [])
    keys = ("name", "bytes", "kind", "params")
    assert ([{k: m.get(k) for k in keys} for m in hc["members"]]
            == [{k: m.get(k) for k in keys} for m in fast["members"]])
    cell = harness.load_cell(CELL)
    assert cell.workload["chips"] == 1 and cell.traffic["create_in_window"]
    assert {"create_MBps", "extract_MBps", "stored_bytes_pct", "setup_s"} <= {
        m["name"] for m in cell.end_to_end}


def test_the_cell_reads_what_silesia_lz4_reads_and_its_own():
    fast = {m["name"] for m in harness.load_cell("silesia-lz4.roundtrip").per_layer}
    hc = {m["name"] for m in harness.load_cell(CELL).per_layer}
    assert hc == fast | {"codec.hc_bytes_pct.create", "extract.launches_per_read",
                         "extract.waits_per_read"}
    assert "kernels.lz4_match_ms_per_MB.create" in fast


def _c(calls, nbytes, parents):
    return {"calls": calls, "seconds": 0.0, "bytes": nbytes, "MBps": 0.0,
            "self_seconds": 0.0, "parents": parents}


def _window(counters=None, trace=None):
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.0, input_bytes=2_000_000)
    w.ops = [Op("create", 0.0, 0.5, 2_000_000, 1_000_000),
             Op("create", 0.5, 1.0, 2_000_000, 1_000_000),
             Op("read", 1.0, 1.5, 100, 2_000_000, "a", True, 0)]
    w.counters = counters if counters is not None else {
        "lz4.compress": _c(4, 4_000_000, {"writer.write_archive": 4}),
        "lz4.compress.hc": _c(3, 3_000_000, {"lz4.compress": 3})}
    w.trace, w.traced_from = trace, 1 if trace else None
    return w


def test_hc_bytes_share():
    assert _read("codec.hc_bytes_pct.create", _window()) == pytest.approx(75.0)
    # a program that counts no HC entry (the parent), and no LZ4 entry
    counters = {"lz4.compress": _c(4, 4_000_000, {"": 4})}
    assert _read("codec.hc_bytes_pct.create", _window(counters)) is None
    assert _read("codec.hc_bytes_pct.create", _window({})) is None


def test_match_kernels_ms_per_mb_created():
    tr = Trace(ops=[("create", 0.0, 1000.0), ("read", 1000.0, 2000.0)], device=[
        ("kernel", "void (anonymous namespace)::tokenize_kernel<0, 1024>(unsigned char const*)",
         100.0, 300.0),
        ("kernel", "void (anonymous namespace)::serialize_kernel<0, 1024, 1>(int)", 300.0, 700.0),
        ("kernel", "void (anonymous namespace)::place_kernel(unsigned char const*)", 700.0, 750.0),
        # outside the create, another kernel, and a copy
        ("kernel", "void (anonymous namespace)::tokenize_kernel<0, 1024>(int)", 1100.0, 1300.0),
        ("kernel", "void (anonymous namespace)::parse_walk_kernel(int)", 800.0, 900.0),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 750.0, 800.0)])
    # the second create is the traced one: 2 MB and 0.65 ms of the kernels
    assert _read("kernels.lz4_match_ms_per_MB.create", _window(trace=tr)) == pytest.approx(
        0.65 / 2)
    assert _read("kernels.lz4_match_ms_per_MB.create", _window()) is None
    tr.device = [d for d in tr.device if "parse" in d[1]]
    assert _read("kernels.lz4_match_ms_per_MB.create", _window(trace=tr)) is None


def _run(trace, seed):
    try:
        result, lines = harness.run(CELL, seed, 2.0, trace, t_start=time.perf_counter(),
                                    device="cpu", scale=SCALE)
    finally:
        engine.uninstall()
    assert result is not None and len(lines) == len(result["checks"])
    return result


def test_traced_run_of_the_hc_cell_is_correct():
    result = _run(True, 2**31 + 197)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    metrics = result["metrics"]
    # every entry at level 9 counts the HC mode, on the device route and
    # on the host's; the host's HC frames are of independent blocks, which
    # read on the device route too; the CPU route runs no hand-written kernel
    assert metrics["codec.hc_bytes_pct.create"]["value"] == pytest.approx(100.0)
    assert metrics["codec.device_entries_pct.extract"]["value"] == pytest.approx(100.0)
    assert "kernels.lz4_match_ms_per_MB.create" not in metrics


def test_sound_run_of_the_hc_cell_reports_its_end_to_end_metrics():
    result = _run(False, 2**31 + 199)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(CELL).end_to_end}
    fast, _ = harness.run("silesia-lz4.roundtrip", 2**31 + 199, 1.0, False,
                          t_start=time.perf_counter(), device="cpu", scale=SCALE)
    engine.uninstall()
    assert (result["metrics"]["stored_bytes_pct"]["value"]
            < fast["metrics"]["stored_bytes_pct"]["value"])


def test_control_of_the_hc_cell_is_not_correct():
    undo = control.install()
    try:
        result = _run(False, 2**31 + 199)
    finally:
        undo()
    assert not result["correct"]
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["archive_faults"] > 0 and checks["blocks_wrong"] > 0
    assert checks["read_faults"] > 0
