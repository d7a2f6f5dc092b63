"""The metric arithmetic: rates over the whole window, the tail over every
request, idle shares from overlapping intervals, the roofline's work."""

import importlib.util

import pytest

from zbench import intervals as iv
from zbench import layers, roofline
from zbench.harness import HERE, Cell, Op, Window
from zbench.trace import Trace, parse


def _e2e(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "end_to_end" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _window():
    w = Window(Cell("c", {}, {}, {}, [], []), setup_s=1.5, input_bytes=4_000_000)
    # two iterations: a create of 4 MB in 1 s, then reads tiling the rest
    w.ops = [Op("create", 0.0, 1.0, 4_000_000, 2_000_000),
             Op("read", 1.0, 1.5, 100, 1_000_000, "a", True, 0),
             Op("read", 1.5, 3.0, 100, 3_000_000, "b", True, 0),
             Op("create", 3.0, 5.0, 4_000_000, 2_000_000),
             Op("read", 5.0, 5.1, 100, 0, "c", False, 1)]
    w.create_spans = [(0.0, 1.0), (3.0, 5.0)]
    w.extract_spans = [(1.0, 3.0), (5.0, 5.1)]
    w.archives = [b"x" * 2_000_000, b"y" * 2_000_000]
    return w


def test_rates_over_all_the_window():
    w = _window()
    assert _e2e("create_MBps")(w) == pytest.approx(8.0 / 3.0)
    # the failed read's time stays in the window; its bytes count nothing
    assert _e2e("extract_MBps")(w) == pytest.approx(4.0 / 2.1)
    assert _e2e("stored_bytes_pct")(w) == pytest.approx(50.0)
    assert _e2e("setup_s")(w) == 1.5


def test_p95_is_over_every_request():
    assert iv.p95(list(range(1, 101))) == 95
    assert iv.p95([3.0]) == 3.0
    assert iv.p95([1, 2, 3, 4, 100]) == 100
    lat = [0.01] * 190 + [1.0] * 10
    assert iv.p95(lat) == 0.01
    assert iv.p95(lat + [1.0]) == 1.0
    w = _window()
    assert _e2e("read_p95_ms")(w) == pytest.approx(1500.0)


def test_idle_from_overlapping_intervals():
    tr = Trace(ops=[("read", 0.0, 10.0), ("read", 10.0, 20.0)],
               device=[("kernel", "k", 1.0, 3.0), ("gpu_memcpy", "m", 2.0, 4.0),
                       ("kernel", "k", 12.0, 13.0), ("kernel", "j", 12.5, 14.0)])
    w = _window()
    w.trace = tr
    # busy 3 + 2 of 20
    assert layers.idle_pct(w, "read") == pytest.approx(75.0)
    assert iv.gaps([(1, 3), (2, 4)], 0, 6) == [(0, 1), (4, 6)]
    assert iv.overlap([(0, 10)], [(5, 15), (8, 9)]) == 5


def test_roofline_work_and_share():
    assert roofline.work_bytes([(10, 30), (5, 5)]) == 50
    assert roofline.share_pct(0, 1.0) is None
    assert roofline.share_pct(3_350_000_000, 0.0) is None
    assert roofline.share_pct(3_350_000_000, 0.01) == pytest.approx(10.0)


def test_roofline_of_reads_counts_device_routed_entries_only():
    w = _window()
    w.ops = [Op("read", 0, 1, 1_000, 3_000, "a", True, 0),
             Op("read", 1, 2, 2_000, 4_000, "b", True, 0)]
    # only the first read ran a kernel: 4,000 bytes in 2 us of kernels
    w.trace = Trace(ops=[("read", 0.0, 10.0), ("read", 10.0, 20.0)],
                    device=[("kernel", "k", 1.0, 3.0), ("gpu_memcpy", "m", 12.0, 13.0)])
    share = layers.roofline_pct(w, "read")
    assert share == pytest.approx(100 * 4_000 / 3.35e12 / 2e-6)


def test_idle_gaps_named_by_innermost_phase():
    spans = [(0, 10, "op:read"), (2, 6, "lz4.decompress"), (3, 4, "torch.lz4f_walk")]
    idle = iv.labelled_overlap(iv.innermost(spans), iv.gaps([(4.5, 5.0)], 0, 10))
    assert idle == pytest.approx({"op:read": 6.0, "lz4.decompress": 2.5,
                                  "torch.lz4f_walk": 1.0})


def test_trace_parse_keeps_ops_phases_and_device_work():
    tr = parse([
        {"ph": "X", "cat": "user_annotation", "name": "op:read", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "phase:lz4.decompress", "ts": 11, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "zp_replay", "ts": 11.5, "dur": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "op:read", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 12, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
    ])
    assert tr.ops == [("read", 10.0, 15.0)]
    assert tr.phases == [("lz4.decompress", 11.0, 13.0)]
    assert tr.device == [("kernel", "zp_replay", 11.5, 12.5)]
    assert tr.kernel_within(12.0, 20.0) and not tr.kernel_within(12.5, 20.0)


def test_counters_cover_the_untraced_half_and_the_trace_the_rest():
    w = _window()
    # a traced run: the counters stopped after the first create and its two
    # reads; the trace holds the second create and its read
    w.traced_from = 3
    w.counters = {"lz4.compress": {"seconds": 0.25, "bytes": 4_000_000},
                  "lz4.decompress": {"seconds": 0.5, "bytes": 4_000_000},
                  "torch.lz4f_walk": {"seconds": 0.2, "bytes": 0}}
    assert [o.kind for o in w.counted_ops("read")] == ["read", "read"]
    assert [o.name for o in w.traced_ops("read")] == ["c"]
    assert layers.mb(w, "create") == pytest.approx(4.0)
    # 1 s of create, 0.25 s of it in the codec: 0.75 s over 4 MB
    assert layers.self_ms_per_mb(w, "create") == pytest.approx(187.5)
    # 2 s of reads, 0.5 s in the codec, over the 4 MB they returned
    assert layers.self_ms_per_mb(w, "read") == pytest.approx(375.0)
    assert layers.ms_per_mb(w, ["torch.lz4f_walk"], "read") == pytest.approx(50.0)
    # an untraced run's counters cover every operation
    w.traced_from = None
    assert len(w.counted_ops("create")) == 2 and len(w.traced_ops("create")) == 2
