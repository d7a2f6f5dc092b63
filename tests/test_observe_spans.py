"""The port's phase registry (``zpack_tpu_torch.utils.observe``): parents and
self time, threads, reset, the profiler ranges of ``observe.trace``, a
wrapper set on the instance as a benchmark sets it, and the spans of a CPU
round trip with the engine installed."""

import ast
import contextlib
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import zstandard

import zpack_tpu_torch as zp
from zpack_tpu_torch import codecs, engine
from zpack_tpu_torch.codecs import zstd as port_zstd
from zpack_tpu_torch.codecs.lz4 import frame as lz4frame
from zpack_tpu_torch.kernels import lz4_torch
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.parallel.extract import decompress_lz4f_batched
from zpack_tpu_torch.parallel.mesh import make_mesh
from zpack_tpu_torch.utils import observe
from zpack_tpu_torch.utils.observe import Metrics, metrics

torch.set_num_threads(1)

PKG = pathlib.Path(zp.__file__).resolve().parent
OLD_KEYS = {"calls", "seconds", "bytes", "MBps"}


def test_nested_phases_record_parents_and_self_time():
    m = Metrics()
    with m.phase("outer", 100):
        time.sleep(0.01)
        for _ in range(2):
            with m.phase("inner", 10):
                time.sleep(0.005)
                with m.phase("leaf"):
                    pass
    s = m.snapshot()
    assert s["outer"]["parents"] == {"": 1}
    assert s["inner"]["parents"] == {"outer": 2}
    assert s["leaf"]["parents"] == {"inner": 2}
    assert s["outer"]["self_seconds"] == pytest.approx(
        s["outer"]["seconds"] - s["inner"]["seconds"], abs=1e-5)
    assert s["inner"]["self_seconds"] == pytest.approx(
        s["inner"]["seconds"] - s["leaf"]["seconds"], abs=1e-5)
    assert s["outer"]["self_seconds"] >= 0.009
    assert s["leaf"]["self_seconds"] == pytest.approx(s["leaf"]["seconds"], abs=1e-6)
    # the old keys keep their meaning
    assert s["inner"]["calls"] == 2 and s["inner"]["bytes"] == 20
    assert s["outer"]["MBps"] == round(100 / s["outer"]["seconds"] / 1e6, 2)
    assert set(s["outer"]) == OLD_KEYS | {"self_seconds", "parents"}


def test_phase_closed_out_of_order_leaves_the_stack_sound():
    """A generator may close its phase after the caller opened another."""
    m = Metrics()

    def gen():
        with m.phase("gen"):
            yield

    g = gen()
    next(g)
    with m.phase("caller"):
        g.close()
    with m.phase("after"):
        pass
    s = m.snapshot()
    assert s["caller"]["parents"] == {"gen": 1}
    assert s["after"]["parents"] == {"": 1}


def test_phase_on_another_thread_has_no_parent():
    m = Metrics()
    with m.phase("main"):
        def work():
            with m.phase("worker"):
                pass

        t = threading.Thread(target=work)
        t.start()
        t.join()
    s = m.snapshot()
    assert s["worker"]["parents"] == {"": 1}
    assert s["main"]["self_seconds"] == pytest.approx(s["main"]["seconds"], abs=1e-6)


def test_reset_clears_everything():
    m = Metrics()
    with m.phase("a", 5):
        with m.phase("b"):
            pass
    m.reset()
    assert m.snapshot() == {}
    with m.phase("b"):
        pass
    assert m.snapshot()["b"]["parents"] == {"": 1} and m.snapshot()["b"]["calls"] == 1
    assert json.loads(m.report())["b"]["calls"] == 1


def test_phase_under_a_bare_profiler_adds_no_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.phase("test.bare"):
            torch.zeros(4).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]
    assert not [n for n in names if n.startswith("phase:")]


def test_trace_ranges_end_with_the_region(tmp_path):
    with observe.trace(str(tmp_path / "prof")):
        with metrics.phase("test.inside"):
            pass
    assert metrics._ranges is None
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("name", "").startswith("phase:")] == \
        ["phase:test.inside"]


# -- the spans of a CPU round trip -------------------------------------------

def _entries():
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[i] for i in rng.integers(0, 300, 200_000))
    lz4 = zp.CompressOptions(zp.CompressionMethod.LZ4, 1)
    zstd = zp.CompressOptions(zp.CompressionMethod.ZSTD, 3)
    # over 1 MiB stored, so the Reader scans the entry for frames in place
    big = text[:400_000] + rng.integers(0, 256, 1_100_000, dtype=np.uint8).tobytes()
    # under the device route's 64 KiB, so the host encoder and decoder
    tiny = text[:3_000]
    return ([("big.bin", big, lz4), ("small.txt", text[:70_000], lz4), ("tiny.txt", tiny, lz4)],
            [("z.txt", text[:300_000], zstd)])


@pytest.fixture(scope="module")
def round_trip():
    """Every span name a CPU round trip opens, counted by a ``(name,
    nbytes=0)`` wrapper set on the instance as the benchmark sets it, and
    the registry's snapshot of the same run."""
    before = codecs.device_setting()
    seen: dict = {}
    orig = metrics.phase

    @contextlib.contextmanager
    def phase(name, nbytes=0):
        seen[name] = seen.get(name, 0) + 1
        with orig(name, nbytes):
            yield

    engine.install("cpu")
    metrics.reset()
    metrics.phase = phase
    try:
        lz4_files, zstd_files = _entries()
        w = zp.Writer.to_heap()
        w.write_archive(lz4_files)
        r = zp.Reader.from_memory(w.buffer)
        for name, data, _ in lz4_files:
            assert r.read_file(name) == data
        w = zp.Writer.to_heap()
        w.write_archive(zstd_files)
        r = zp.Reader.from_memory(w.buffer)
        for name, data, _ in zstd_files:
            assert r.read_file(name) == data
        # a read whose decoders shard over two devices, and an entry whose
        # frame declares no size (the zstd route's exact path)
        device_route = extract.decompress_zstd_device
        extract.decompress_zstd_device = lambda *a, **k: device_route(
            *a, **k, mesh=make_mesh(["cpu", "cpu"]))
        try:
            assert r.read_file(zstd_files[0][0]) == zstd_files[0][1]
        finally:
            extract.decompress_zstd_device = device_route
        compress = port_zstd.ZstdCodec.compress
        port_zstd.ZstdCodec.compress = lambda self, data, level=3, **k: zstandard.ZstdCompressor(
            level=level, write_content_size=False).compress(data)
        try:
            w = zp.Writer.to_heap()
            w.write_archive(zstd_files)
        finally:
            port_zstd.ZstdCodec.compress = compress
        r = zp.Reader.from_memory(w.buffer)
        for name, data, _ in zstd_files:
            assert r.read_file(name) == data
        text = zstd_files[0][1][:200_000]
        frame = lz4frame.compress_frame(text, 1, block_indep=True, content_checksum=True)
        assert decompress_lz4f_batched(frame, len(text), device="cpu") == text
    finally:
        metrics.__dict__.pop("phase", None)
        codecs.set_device(before)
    return seen, metrics.snapshot()


def test_popping_the_wrapper_restores_phase(round_trip):
    assert "phase" not in metrics.__dict__
    assert metrics.phase.__func__ is Metrics.phase


def test_wrapper_on_the_instance_sees_every_span(round_trip):
    seen, snap = round_trip
    counts = {"torch.zstd_resize", *ROUTE_COUNTS}  # metrics.count, no span
    assert seen == {k: v["calls"] for k, v in snap.items() if k not in counts}


PARENTS = {
    "writer.write_archive": {""},
    "writer.xxh3": {"writer.write_archive"},
    "writer.emit": {"writer.write_archive", "writer.records"},
    "writer.records": {"writer.write_archive"},
    "writer.buffer": {""},
    "lz4.compress": {"writer.write_archive"},
    "zstd.compress": {"writer.write_archive"},
    "torch.stage": {"lz4.compress"},
    "torch.dispatch": {"lz4.compress"},
    "torch.d2h": {"lz4.compress"},
    "torch.d2h.wait": {"torch.d2h"},
    "torch.serialize": {"lz4.compress"},
    "torch.frame": {"lz4.compress"},
    "reader.open": {""},
    "reader.read_file": {""},
    "reader.slice": {"reader.read_file"},
    "reader.xxh3": {"reader.read_file"},
    "reader.lz4_scan": {"reader.read_file"},
    "lz4.decompress": {"reader.read_file"},
    "torch.lz4f_walk": {"lz4.decompress", ""},
    "torch.lz4f_join": {"lz4.decompress", ""},
    "torch.lz4f_checksum": {"torch.lz4f_join"},
    "zstd.decompress": {"reader.read_file"},
    "torch.zstd_walk": {"zstd.decompress"},
    "torch.zstd_walk.native": {"torch.zstd_walk"},
    "torch.zstd_walk.literals": {"torch.zstd_walk", "torch.zstd_walk.native"},
    "torch.zstd_walk.sequences": {"torch.zstd_walk", "torch.zstd_walk.native"},
    "torch.zstd_walk.layout": {"torch.zstd_walk"},
    "torch.huffman_decode": {"zstd.decompress"},
    "torch.huffman_decode.wait": {"torch.huffman_decode"},
    "torch.fse_decode": {"zstd.decompress"},
    "torch.fse_decode.wait": {"torch.fse_decode"},
    "torch.rep_resolve": {"zstd.decompress"},
    "torch.zstd_stage": {"zstd.decompress"},
    "torch.zstd_assemble": {"zstd.decompress"},
    "torch.zstd_assemble.wait": {"torch.zstd_assemble"},
    "torch.zstd_resize": {"torch.zstd_assemble"},
    "torch.replay": {"zstd.decompress"},
    "torch.replay.wait": {"torch.replay"},
    "torch.zstd_checksum": {"zstd.decompress"},
    "torch.zstd_join": {"zstd.decompress"},
    # counts: each LZ4 entry's route, under its codec phase
    "lz4.compress.device": {"lz4.compress"},
    "lz4.compress.host": {"lz4.compress"},
    "lz4.decompress.device": {"lz4.decompress"},
    "lz4.decompress.host": {"lz4.decompress"},
    # each shard's serializer route, under its serialize phase (the CPU's here)
    "lz4.serialize.host": {"torch.serialize"},
}
ROUTE_COUNTS = [n for n in PARENTS
                if n.startswith(("lz4.compress.", "lz4.decompress.", "lz4.serialize."))]


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_appears_under_its_parent(round_trip, name):
    _, snap = round_trip
    assert name in snap, sorted(snap)
    assert set(snap[name]["parents"]) <= PARENTS[name]
    assert snap[name]["calls"] == sum(snap[name]["parents"].values())


def test_codec_phases_are_never_nested(round_trip):
    _, snap = round_trip
    codec = {"lz4.compress", "zstd.compress", "lz4.decompress", "zstd.decompress"}
    for name in codec:
        assert not set(snap[name]["parents"]) & codec


def test_self_time_is_the_time_outside_children(round_trip):
    _, snap = round_trip
    inner: dict = {}
    for name, v in snap.items():
        for parent, calls in v["parents"].items():
            if parent and calls == v["calls"]:
                inner[parent] = inner.get(parent, 0.0) + v["seconds"]
    for parent, secs in inner.items():
        v = snap[parent]
        assert v["self_seconds"] <= v["seconds"] - secs + 1e-4


# -- the call sites ------------------------------------------------------------

def _phase_lookups(tree):
    """Every ``metrics.phase`` attribute in ``tree``."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "phase"
            and isinstance(n.value, ast.Name) and n.value.id == "metrics"]


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")))
def test_phase_is_called_with_a_name_and_bytes_only(path):
    """Every ``metrics.phase`` is looked up at its call and passed
    ``(name)`` or ``(name, nbytes)``: a wrapper set on the instance sees it."""
    tree = ast.parse((PKG / path).read_text())
    calls = {id(n.func): n for n in ast.walk(tree) if isinstance(n, ast.Call)}
    for node in _phase_lookups(tree):
        call = calls.get(id(node))
        assert call is not None, f"{path}:{node.lineno} binds metrics.phase ahead of the call"
        assert 1 <= len(call.args) <= 2 and all(k.arg == "nbytes" for k in call.keywords), \
            f"{path}:{call.lineno}"


def _count_lookups(tree):
    """Every ``metrics.count`` attribute in ``tree``."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "count"
            and isinstance(n.value, ast.Name) and n.value.id == "metrics"]


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")))
def test_count_is_called_with_a_name_and_counts_only(path):
    """Every ``metrics.count`` is looked up at its call and passed
    ``(name)``, ``(name, n)`` or ``(name, n, nbytes)``, the name a string
    or a string plus a key."""
    tree = ast.parse((PKG / path).read_text())
    calls = {id(n.func): n for n in ast.walk(tree) if isinstance(n, ast.Call)}
    for node in _count_lookups(tree):
        call = calls.get(id(node))
        assert call is not None, f"{path}:{node.lineno} binds metrics.count ahead of the call"
        assert 1 <= len(call.args) <= 3 and all(k.arg in ("n", "nbytes") for k in call.keywords), \
            f"{path}:{call.lineno}"
        name = call.args[0]
        if isinstance(name, ast.BinOp):
            name = name.left
        assert isinstance(name, ast.Constant) and isinstance(name.value, str), \
            f"{path}:{call.lineno}"


# -- counts ---------------------------------------------------------------------

def test_count_lands_under_the_open_phase():
    m = Metrics()
    m.count("launch.k")
    with m.phase("outer"):
        m.count("launch.k", 2, nbytes=64)
        with m.phase("inner"):
            m.count("launch.k")
            m.count("launch.j")
    s = m.snapshot()
    assert s["launch.k"]["calls"] == 4 and s["launch.k"]["bytes"] == 64
    assert s["launch.k"]["parents"] == {"": 1, "outer": 2, "inner": 1}
    assert s["launch.j"]["parents"] == {"inner": 1}
    assert set(s["launch.k"]) == OLD_KEYS | {"self_seconds", "parents"}


def test_count_on_another_thread_has_no_parent():
    m = Metrics()
    with m.phase("main"):
        t = threading.Thread(target=lambda: m.count("launch.k"))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert m.snapshot()["launch.k"]["parents"] == {"": 1}


def test_count_takes_no_time_and_leaves_self_time_alone():
    m = Metrics()
    with m.phase("outer"):
        time.sleep(0.005)
        for _ in range(1000):
            m.count("launch.k")
    s = m.snapshot()
    assert s["launch.k"]["seconds"] == 0 and s["launch.k"]["self_seconds"] == 0
    assert s["launch.k"]["MBps"] == 0.0
    assert s["outer"]["self_seconds"] == s["outer"]["seconds"]


def test_count_survives_reset_and_snapshot():
    m = Metrics()
    with m.phase("a"):
        m.count("launch.k")
    first = m.snapshot()
    first["launch.k"]["parents"]["a"] = 99  # a snapshot is a copy
    assert m.snapshot()["launch.k"]["parents"] == {"a": 1}
    m.reset()
    assert m.snapshot() == {}
    m.count("launch.k", 3)
    assert m.snapshot()["launch.k"]["calls"] == 3
    assert json.loads(m.report())["launch.k"]["parents"] == {"": 3}


def _launch_sites(tree) -> tuple[list, list]:
    """``(function, key)`` of every ``launched(key)`` call in source order,
    the key as source; and the line of every ``metrics.count`` of a
    ``launch.`` name, a launch recorded beside the helper."""
    sites, beside = [], []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call) and child.args:
                f, arg = child.func, ast.unparse(child.args[0])
                if isinstance(f, ast.Name) and f.id == "launched":
                    sites.append((fn, arg))
                elif (isinstance(f, ast.Attribute) and f.attr == "count"
                      and isinstance(f.value, ast.Name) and f.value.id == "metrics"
                      and "launch." in arg):
                    beside.append(child.lineno)
            visit(child, child.name if isinstance(child, ast.FunctionDef) else fn)

    visit(tree, None)
    return sites, beside


def _module_tuples(tree) -> dict:
    """Each module-level tuple of string constants, by its name."""
    return {t.id: {e.value for e in node.value.elts} for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple)
            and all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in node.value.elts)
            for t in node.targets if isinstance(t, ast.Name)}


def _launch_keys(tree, sites) -> set:
    """The kernel names the sites record: a constant key itself, a
    parameter every constant its function's callers pass first,
    ``launch_key(mode)`` every tokenizer mode's name, and an item of a
    module-level tuple of names (``KERNELS[k]``) every name of the tuple."""
    passed: dict = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.args
                and isinstance(node.args[0], ast.Constant)):
            passed.setdefault(node.func.id, set()).add(node.args[0].value)
    keys = set()
    for fn, key in sites:
        expr = ast.parse(key, mode="eval").body
        if key == "launch_key(mode)":
            keys |= {lz4_torch.launch_key(m) for m in lz4_torch.MODES}
        elif isinstance(expr, ast.Constant):
            keys.add(ast.literal_eval(key))
        elif isinstance(expr, ast.Subscript) and isinstance(expr.value, ast.Name):
            keys |= _module_tuples(tree).get(expr.value.id, set())
        else:
            keys |= passed.get(fn, set())
    return keys


def _launch_problems(tree, want_sites, want_keys) -> list[str]:
    sites, beside = _launch_sites(tree)
    problems = [f"line {n}: a launch counted beside the helper" for n in beside]
    if sites != want_sites:
        problems.append(f"launch sites {sites}, not {want_sites}")
    keys = _launch_keys(tree, sites)
    if keys != want_keys:
        problems.append(f"kernels {sorted(keys)}, not {sorted(want_keys)}")
    return problems


#: each kernel module's launch sites (function, key) in source order, and the
#: kernels they record: one site a launch the module's wrappers make
KERNEL_MODULES = {
    "kernels/huffman_torch.py": (
        [("encode_streams", "'huffman_encode'"), ("decode_streams", "'huffman_decode'")],
        {"huffman_encode", "huffman_decode"}),
    "kernels/fse_torch.py": (
        [("encode_seq_streams", "'fse_encode'"), ("decode_seq_streams", "'fse_decode'"),
         ("_rep_launch", "name")],
        {"fse_encode", "fse_decode", "rep_totals", "rep_apply"}),
    "kernels/lz4_torch.py": (
        [("tokenize_est", "launch_key(mode)"), ("serialize_sections", "SERIALIZE_KEYS[k]"),
         ("parse_batch", "'lz4_parse'"), ("replay_enqueue", "'lz4_replay'")],
        {"lz4_tokenize", "lz4_tokenize_u16", "lz4_tokenize_hash", "lz4_tokenize_scatter",
         "lz4_serialize", "lz4_serialize_hc", "lz4_parse", "lz4_replay"}),
    "kernels/xxh3_torch.py": (
        [("accumulate_batch", "'xxh3_batch'"), ("accumulate_stream", "'xxh3_stream'")],
        {"xxh3_batch", "xxh3_stream"}),
    "kernels/assemble_torch.py": (
        [("_launch", "name")], {"zstd_stitch", "zstd_layout", "zstd_trim"}),
    # the zstd read's native chain: each launch it reports, by its code
    "kernels/zstd_chain.py": (
        [("enqueue", "KERNELS[k]")],
        {"huffman_decode", "fse_decode", "rep_totals", "zstd_stitch", "rep_apply", "zstd_layout",
         "lz4_replay", "zstd_trim"}),
}


@pytest.mark.parametrize("path", list(KERNEL_MODULES))
def test_every_launch_is_counted_in_the_registry(path):
    """Each kernel module records its launches through
    ``observe.launched``, which counts ``launch.<key>`` under the phase
    open: at its known sites, under its known kernel names, and never with
    a ``metrics.count`` of its own."""
    assert _launch_problems(ast.parse((PKG / path).read_text()), *KERNEL_MODULES[path]) == []


def test_launch_check_sees_a_missing_count():
    good = ("def f(k):\n    launched('a')\n    launched(k)\n\n"
            "def g():\n    f('b')\n    launched('c')\n")
    want = [("f", "'a'"), ("f", "k"), ("g", "'c'")], {"a", "b", "c"}
    assert _launch_problems(ast.parse(good), *want) == []
    # g's launch counted beside the helper: a site and a kernel missing
    bad = good.replace("launched('c')", "metrics.count('launch.c')")
    got = _launch_problems(ast.parse(bad), *want)
    assert len(got) == 3 and got[0] == "line 7: a launch counted beside the helper"
    # a site with no count at all
    got = _launch_problems(ast.parse(good.replace("    launched('c')\n", "")), *want)
    assert len(got) == 2 and got[0].startswith("launch sites")
    # a key from a tuple of names: each name, and a tuple short of one is seen
    table = "NAMES = ('a', 'b')\n\ndef f(codes):\n    for k in codes:\n        launched(NAMES[k])\n"
    assert _launch_problems(ast.parse(table), [("f", "NAMES[k]")], {"a", "b"}) == []
    got = _launch_problems(ast.parse(table.replace(", 'b'", "")), [("f", "NAMES[k]")], {"a", "b"})
    assert len(got) == 1 and got[0].startswith("kernels")


# -- the LZ4 route counts ---------------------------------------------------------

def test_round_trip_counts_one_route_an_lz4_entry(round_trip):
    """Two entries over 64 KiB on the device route, one under it on the
    host's, on create and on read, each with its bytes."""
    _, snap = round_trip
    lz4_files, _ = _entries()
    dev = sum(len(d) for n, d, _ in lz4_files if n != "tiny.txt")
    tiny = len(lz4_files[2][1])
    for kind in ("compress", "decompress"):
        assert (snap[f"lz4.{kind}.device"]["calls"], snap[f"lz4.{kind}.device"]["bytes"]) == (2, dev)
        assert (snap[f"lz4.{kind}.host"]["calls"], snap[f"lz4.{kind}.host"]["bytes"]) == (1, tiny)
        assert snap[f"lz4.{kind}"]["calls"] == 3


def test_in_place_read_counts_the_host_route():
    """An entry of many frames over 1 MiB stored (the host's chunked
    encoder, no engine) read with the engine installed: the Reader decodes
    it in place on the host, and counts that route once."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (2 << 20) + 4096, dtype=np.uint8).tobytes()
    before = codecs.device_setting()
    try:
        engine.uninstall()
        w = zp.Writer.to_heap()
        w.write_archive([("many.bin", data, zp.CompressOptions(zp.CompressionMethod.LZ4, 1))])
        engine.install("cpu")
        m = Metrics()
        r = zp.Reader.from_memory(w.buffer)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("zpack_tpu_torch.reader.metrics", m)
            assert r.read_file("many.bin") == data
    finally:
        codecs.set_device(before)
    snap = m.snapshot()
    assert "reader.lz4_scan" in snap
    assert snap["lz4.decompress.host"]["calls"] == 1
    assert snap["lz4.decompress.host"]["bytes"] == len(data)
    assert snap["lz4.decompress.host"]["parents"] == {"lz4.decompress": 1}
    assert "lz4.decompress.device" not in snap


def test_hc_levels_count_each_lz4_entry_on_either_route():
    """The bytes LZ4's high-compression mode took count ``lz4.compress.hc``:
    on the device route once a shard the HC parse serialized, under its
    serializer's phase; on the host route once an entry, under its codec
    phase.  An entry at level 1 counts none."""
    lz4_files, _ = _entries()
    hc = zp.CompressOptions(zp.CompressionMethod.LZ4, 9)
    files = [(n, d, hc) for n, d, _ in lz4_files[1:]] + [lz4_files[0]]
    before = codecs.device_setting()
    engine.install("cpu")
    metrics.reset()
    try:
        w = zp.Writer.to_heap()
        w.write_archive(files)
        snap = metrics.snapshot()
        r = zp.Reader.from_memory(w.buffer)
        for name, data, _ in files:
            assert r.read_file(name) == data
    finally:
        codecs.set_device(before)
    hc_bytes = sum(len(d) for _, d, _ in files[:2])
    assert (snap["lz4.compress.hc"]["calls"], snap["lz4.compress.hc"]["bytes"]) == (2, hc_bytes)
    assert snap["lz4.compress.hc"]["parents"] == {"torch.serialize": 1, "lz4.compress": 1}
    assert snap["lz4.compress.device"]["calls"] == 2
    assert snap["lz4.compress.host"]["calls"] == 1


def test_hc_count_follows_the_parse_taken():
    """The device route counts ``lz4.compress.hc`` by the parse its
    serializer took, not by the level asked for."""
    from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

    data = _entries()[0][1][1]
    for parse, want in (("hc", len(data)), ("greedy", None)):
        dc = DeviceCompressor("cpu", 9)
        dc.parse = parse
        metrics.reset()
        dc.compress(data)
        assert (metrics.snapshot().get("lz4.compress.hc") or {}).get("bytes") == want


def _route_sites(tree) -> list:
    """``(function, name, phase)`` of every ``metrics.count`` of an
    ``lz4.`` name in source order, with the ``metrics.phase`` name of the
    innermost ``with`` around it (None outside any)."""
    sites = []

    def visit(node, fn, phase):
        for child in ast.iter_child_nodes(node):
            inner = phase
            if isinstance(child, ast.With):
                for item in child.items:
                    call = item.context_expr
                    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "phase" and call.args
                            and isinstance(call.args[0], ast.Constant)):
                        inner = call.args[0].value
            if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "count" and isinstance(child.func.value, ast.Name)
                    and child.func.value.id == "metrics" and child.args
                    and isinstance(child.args[0], ast.Constant)
                    and str(child.args[0].value).startswith("lz4.")):
                sites.append((fn, child.args[0].value, phase))
            visit(child, child.name if isinstance(child, ast.FunctionDef) else fn, inner)

    visit(tree, None, None)
    return sites


#: each module's LZ4 route counts (function, name, codec phase open) in
#: source order: one count an entry, whichever branch it takes; the
#: pipeline's one a shard, by where its blocks were serialized and, at an
#: HC level, by the parse its serializer took
ROUTE_MODULES = {
    "codecs/lz4/__init__.py": [
        ("compress", "lz4.compress.device", "lz4.compress"),
        ("compress", "lz4.compress.host", "lz4.compress"),
        ("compress", "lz4.compress.hc", "lz4.compress"),
        ("decompress", "lz4.decompress.device", "lz4.decompress"),
        ("decompress", "lz4.decompress.host", "lz4.decompress")],
    "reader.py": [("_read_lz4_inplace", "lz4.decompress.host", "lz4.decompress")],
    "parallel/pipeline.py": [
        ("compress", "lz4.serialize.device", "torch.serialize"),
        ("compress", "lz4.compress.hc", "torch.serialize"),
        ("compress", "lz4.serialize.host", "torch.serialize"),
        ("compress", "lz4.compress.hc", "torch.serialize")],
}


def test_every_route_count_is_at_its_site():
    """The LZ4 routes are counted at their known sites only, each inside
    its phase (the codec's; the serializer's for a shard's serializer),
    and nowhere else in the package."""
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        sites = _route_sites(ast.parse(path.read_text()))
        if sites:
            found[path.relative_to(PKG).as_posix()] = sites
    assert found == ROUTE_MODULES


def test_route_check_sees_a_count_out_of_place():
    good = ("def compress(d):\n    with metrics.phase('lz4.compress', len(d)):\n"
            "        if d:\n            metrics.count('lz4.compress.device', nbytes=len(d))\n"
            "            return d\n        metrics.count('lz4.compress.host', nbytes=len(d))\n")
    want = [("compress", "lz4.compress.device", "lz4.compress"),
            ("compress", "lz4.compress.host", "lz4.compress")]
    assert _route_sites(ast.parse(good)) == want
    # a count moved out of the codec phase, and one left out
    outside = good.replace("    with metrics.phase('lz4.compress', len(d)):\n", "    if True:\n")
    assert [p for _, _, p in _route_sites(ast.parse(outside))] == [None, None]
    missing = good.replace("        metrics.count('lz4.compress.host', nbytes=len(d))\n", "")
    assert _route_sites(ast.parse(missing)) == want[:1]
