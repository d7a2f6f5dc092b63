"""One run of one cell: set-up, the measured window, the comparison with the
reference, the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``zbench/configs/<config>.json``: the members, method and level;
* ``zbench/gen/<kind>.py``: the generator of a member's kind;
* ``zbench/traffic/<traffic>.json``: the parameters of the loop below
  (``create_in_window``: whether each iteration creates an archive, or
  the set-up makes one that the window reads; ``block_sample``: how many
  LZ4 blocks or zstd frames the reference decodes);
* ``zbench/end_to_end/<metric>.py`` and ``zbench/metrics/<metric>.py``:
  each a ``read(window)`` that returns the metric's value, or None where
  the run holds nothing to read it from.

The window drives the program's own entry points, ``Writer.to_heap()`` →
``write_archive(...)`` → ``buffer`` for a create and ``Reader.from_memory``
→ ``read_file(name)`` for a read, on the card the engine is installed on.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import corpus
from . import intervals as iv
from .reference import archive as zarc
from .reference import check as refcheck

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "zbench"
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "zpack_tpu")
#: reads the reference compares byte for byte, drawn from the seed, besides
#: the first read of the longest entry
READ_SAMPLE = 32


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{work['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, work, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def _reader(kind: str, metric: str):
    path = HERE / kind / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"zbench.{kind}.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Op:
    kind: str          # "create" or "read"
    t0: float
    t1: float
    bytes_in: int      # create: input bytes; read: the entry's compressed bytes
    bytes_out: int     # create: archive bytes; read: bytes returned
    name: str = ""
    ok: bool = True
    archive: int = -1  # read: the index of its archive in ``Window.archives``


@dataclass
class Window:
    """What the per-metric readers read: the window's operations on the
    host clock, the program's counters, and (traced runs) the device trace.

    A traced run reads the program's counters over the first half of its
    window, untraced, and the card over the second half, under the
    profiler (which records every host operation and so would slow the
    host phases, and unevenly): ``ops[:traced_from]`` are the operations
    the counters saw, ``ops[traced_from:]`` those the trace holds.  An
    untraced run's counters cover the whole window."""

    cell: Cell
    setup_s: float
    ops: list = field(default_factory=list)
    create_spans: list = field(default_factory=list)
    extract_spans: list = field(default_factory=list)
    archives: list = field(default_factory=list)  # bytes of each archive made
    catalogs: list = field(default_factory=list)  # each archive's entries, by the reference
    input_bytes: int = 0                               # bytes of one archive's entries
    counters: dict = field(default_factory=dict)
    fallbacks: dict | None = None
    trace: object = None
    traced_from: int | None = None

    def ops_of(self, kind: str) -> list[Op]:
        return [o for o in self.ops if o.kind == kind and o.ok]

    def counted_ops(self, kind: str) -> list[Op]:
        """The operations of ``kind`` that the counters cover, failed ones too."""
        return [o for o in self.ops[:self.traced_from] if o.kind == kind]

    def traced_ops(self, kind: str) -> list[Op]:
        """The operations of ``kind`` that the trace holds, failed ones too."""
        return [o for o in self.ops[self.traced_from or 0:] if o.kind == kind]

    def counter(self, name: str, key: str = "seconds") -> float | None:
        c = self.counters.get(name)
        return None if c is None else c[key]


class Sample:
    """A reservoir of reads drawn from the seed, plus the first read of the
    longest entry: the reads the reference compares byte for byte.

    The set-up fills the reservoir with placeholders of the sizes of reads
    (:meth:`prefill`), which the window's reads replace as reads replace
    each other.  The reservoir holds some hundreds of MB, and the host's
    heap grows to hold them: filled inside the window, its first passes of
    reads ran 30 to 70% slower than the later ones."""

    def __init__(self, size: int, rng: np.random.Generator, longest: str):
        self.size, self.rng, self.longest = size, rng, longest
        self.kept: list = []
        self.first_longest = None
        self.seen = 0

    def prefill(self, sizes) -> None:
        self.kept = [(None, bytes(n)) for n in sizes[:self.size]]
        self.seen = len(self.kept)

    def offer(self, name: str, out: bytes) -> None:
        if name == self.longest and self.first_longest is None:
            self.first_longest = (name, out)
            return
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((name, out))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.kept[j] = (name, out)

    def reads(self) -> list:
        kept = [r for r in self.kept if r[0] is not None]
        return kept + ([self.first_longest] if self.first_longest else [])


def _sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", scale: float = 1.0, log=None):
    """Run one cell.  Returns ``(result, lines)``: the result object, or
    None when the run must print none, and the lines for standard error.
    ``t_start`` is the process's start on the ``perf_counter`` clock.
    ``device`` and ``scale`` other than "cuda" and 1 are for the tests."""
    import torch

    import zpack_tpu_torch as zp
    from zpack_tpu_torch import engine
    from zpack_tpu_torch.utils.observe import metrics as program_metrics

    from . import trace as ztrace

    log = log or (lambda *_: None)
    cell = load_cell(workload)
    cfg, traffic = cell.config, cell.traffic
    engine.install(device)
    files = corpus.build(cfg, seed, scale, workers=4)
    contents = dict(files)
    opts = zp.CompressOptions(zp.CompressionMethod(cfg["method"]), cfg["level"])
    batch = [(n, d, opts) for n, d in files]
    names = [n for n, _ in files]
    longest = max(files, key=lambda f: len(f[1]))[0]
    input_bytes = sum(len(d) for _, d in files)
    order_rng = np.random.default_rng([seed % (1 << 64), 1])
    sample = Sample(READ_SAMPLE, np.random.default_rng([seed % (1 << 64), 2]), longest)
    marks = torch.profiler.record_function if trace else (lambda _: contextlib.nullcontext())
    in_window = traffic["create_in_window"]

    def create() -> bytes:
        w = zp.Writer.to_heap()
        w.write_archive(batch)
        return w.buffer

    # set-up: the archive of an extract cell, and one pass of the cell's own
    # work to warm every shape the window uses
    made = None if in_window else create()
    reader = zp.Reader.from_memory(made) if made is not None else None
    warm = create() if in_window else made
    warm_reader = zp.Reader.from_memory(warm)
    for n in names:
        warm_reader.read_file(n)
    del warm_reader, warm
    cycle = np.random.default_rng([seed % (1 << 64), 3]).permutation(len(names))
    sample.prefill([len(files[int(k)][1]) for k in np.resize(cycle, READ_SAMPLE)])
    _sync(torch, device)
    fall = getattr(importlib.import_module("zpack_tpu_torch.codecs.zstd"), "FALLBACKS", None)
    fall0 = dict(fall) if fall is not None else None
    prof = undo = None
    if trace:
        prof = ztrace.Profiler(torch)
        prof.prepare()
    program_metrics.reset()
    win = Window(cell, setup_s=0.0, input_bytes=input_bytes)
    if made is not None:
        win.archives.append(made)
    sizes: list = []
    t_win = time.perf_counter()
    win.setup_s = t_win - t_start
    deadline = t_win + seconds
    switch = t_win + seconds / 2 if trace else math.inf
    log(f"set-up {win.setup_s:.3f} s; window of {seconds} s")

    def start_trace() -> None:
        # the counters stop here; the profiler covers the rest of the window
        nonlocal undo, switch
        win.counters, win.traced_from = program_metrics.snapshot(), len(win.ops)
        _sync(torch, device)
        undo = ztrace.mirror_phases(program_metrics, torch.profiler.record_function)
        prof.start()
        switch = math.inf

    now = t_win
    while now < deadline:
        if now >= switch:
            start_trace()
            now = time.perf_counter()
        span0 = now
        if in_window:
            try:
                with marks("op:create"):
                    buf = create()
                ok = True
            except Exception as e:  # a failed create is counted, not fatal
                log(f"create failed: {e!r}")
                buf, ok = b"", False
            now = time.perf_counter()
            win.ops.append(Op("create", span0, now, input_bytes, len(buf), ok=ok))
            win.create_spans.append((span0, now))
            span0 = now
            if not ok:
                continue
            win.archives.append(buf)
            try:
                reader = zp.Reader.from_memory(buf)
            except Exception as e:
                log(f"open failed: {e!r}")
                win.ops.append(Op("read", now, time.perf_counter(), 0, 0, ok=False))
                now = time.perf_counter()
                continue
        for k in order_rng.permutation(len(names)).tolist():
            if now >= deadline:
                break
            if now >= switch and not in_window:
                start_trace()
            name = names[k]
            t0 = time.perf_counter()
            try:
                with marks("op:read"):
                    out = reader.read_file(name)
                ok = True
            except Exception as e:
                log(f"read of {name} failed: {e!r}")
                out, ok = b"", False
            now = time.perf_counter()
            win.ops.append(Op("read", t0, now, 0, len(out), name, ok, len(win.archives) - 1))
            sizes.append((name, len(out)))
            if ok:
                sample.offer(name, out)
        win.extract_spans.append((span0, now))
    _sync(torch, device)
    for kind in ("create", "read"):
        d = sorted(o.t1 - o.t0 for o in win.ops_of(kind))
        if d:
            q = [d[int(f * (len(d) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
            log(f"{kind}: {len(d)} in the window, s min q1 median q3 max "
                + " ".join(f"{x:.4f}" for x in q))
    # the rate of each quarter of the window: how far a run drifts within
    # itself, beside how far runs differ
    quarters = [0.0] * 4, [0.0] * 4
    for o in win.ops_of("read"):
        k = min(3, int(4 * (o.t0 - t_win) / seconds))
        quarters[0][k] += o.bytes_out
        quarters[1][k] += o.t1 - o.t0
    log("read MB/s by quarter of the window (read time only): "
        + " ".join(f"{b / t / 1e6:.2f}" if t else "-" for b, t in zip(*quarters)))
    if not trace:
        win.counters = program_metrics.snapshot()
    if fall is not None:
        win.fallbacks = {k: fall[k] - fall0.get(k, 0) for k in fall}
    if prof is not None:
        win.trace = prof.stop()
    if undo is not None:
        undo()
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        return None, [f"modules that no run may load are loaded: {', '.join(loaded)}"]
    del reader
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # the comparison with the reference, after the window
    t_ref = time.perf_counter()
    hashes = refcheck.reference_hashes(contents)
    rng = refcheck.sample_rng(seed)
    counts, blocks = refcheck.check_archives(win.archives, names, contents, hashes,
                                             cfg["method"], rng, traffic["block_sample"])
    counts.update(refcheck.check_reads(sample.reads(), sizes, contents))
    counts["ops_failed"] = sum(not o.ok for o in win.ops)
    numbers = refcheck.compared(counts)
    correct = refcheck.verdict(numbers) and bool(win.ops_of("read")) and bool(win.archives)
    log(f"reference: {len(win.archives)} archives, {blocks} blocks or frames decoded, "
        f"{len(sample.reads())} reads compared, {time.perf_counter() - t_ref:.2f} s; "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    win.catalogs = [zarc.parse(a)[0] for a in win.archives]
    comp = [{e.name: e.comp_size for e in c} for c in win.catalogs]
    for o in win.ops:
        if o.kind == "read" and o.ok:
            o.bytes_in = comp[o.archive].get(o.name, 0)

    values = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        kind = "metrics" if trace else "end_to_end"
        v = _reader(kind, m["name"])(win)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.startswith("cuda") else "cpu",
        "kind": torch.cuda.get_device_name() if device.startswith("cuda") else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
        "power_limit": _power_limit() if device.startswith("cuda") else None,
    }
    result = {
        "correct": correct,
        "attempted": len(win.ops),
        "failed": counts["ops_failed"],
        "metrics": values,
        "device": dev,
    }
    if trace:
        busy, length = _busy(win.trace) if win.trace else (0.0, 0.0)
        dev["busy_s"], dev["window_s"] = busy, length
        result["breakdown"] = _breakdown(win.trace) if win.trace else {}
    result["checks"] = {k: {"value": v, "limit": refcheck.LIMITS[k]} for k, v in numbers.items()}
    lines = [f"{k} {v} limit {refcheck.LIMITS[k]}" for k, v in numbers.items()]
    return result, lines


def _busy(tr) -> tuple[float, float]:
    if not tr.ops:
        return 0.0, 0.0
    lo, hi = tr.window()
    return iv.length(iv.clip(tr.device_intervals(), lo, hi)) / 1e6, (hi - lo) / 1e6


def _breakdown(tr) -> dict:
    """The device operations that took most time, and the idle time of the
    card under each host phase (the innermost range open), longest first."""
    if not tr.ops:
        return {"device_ops": [], "idle_gaps": []}
    lo, hi = tr.window()
    by_name: dict = {}
    for _, name, s, e in tr.device:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    spans = [(s, e, "op:" + k) for k, s, e in tr.ops] + [(s, e, n) for n, s, e in tr.phases]
    idle = iv.labelled_overlap(iv.innermost(spans), iv.gaps(tr.device_intervals(), lo, hi))
    return {"device_ops": _top(by_name), "idle_gaps": _top({k: v / 1e6 for k, v in idle.items()})}


def _top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda x: -x[1])[:10]]


def _power_limit() -> str | None:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None
