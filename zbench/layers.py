"""Arithmetic shared by the per-layer readers (``zbench/metrics/``)."""

from __future__ import annotations

import bisect

from . import intervals as iv
from . import roofline

#: the codec phases of the program's ``metrics`` registry, by operation
CODEC_PHASES = {"create": ("lz4.compress", "zstd.compress"),
                "read": ("lz4.decompress", "zstd.decompress")}


def mb(w, kind: str) -> float:
    """MB (10^6 bytes) that the operations of ``kind`` the counters cover
    handled: a create's input, a read's output."""
    ops = [o for o in w.counted_ops(kind) if o.ok]
    return sum(o.bytes_in if kind == "create" else o.bytes_out for o in ops) / 1e6


def ms_per_mb(w, phases, kind: str) -> float | None:
    """Host milliseconds the program's ``phases`` took over the operations
    the counters cover, per MB of ``kind``; None when none of them ran."""
    secs = [w.counter(p) for p in phases]
    if all(s is None for s in secs) or not mb(w, kind):
        return None
    return 1e3 * sum(s for s in secs if s is not None) / mb(w, kind)


def self_ms_per_mb(w, kind: str) -> float | None:
    """The operations' own time, outside the codec phases inside them, in
    ms per MB: the archive layer's work (records, hashes, sinks).  The
    codec phases run only inside the operations, one at a time and never
    nested, so their summed time is the part of the operations' time that
    they take."""
    ops = w.counted_ops(kind)
    if not ops or not mb(w, kind) or not w.counters:
        return None
    codec = sum(w.counter(p) or 0.0 for p in CODEC_PHASES[kind])
    return 1e3 * (sum(o.t1 - o.t0 for o in ops) - codec) / mb(w, kind)


def idle_pct(w, kind: str) -> float | None:
    """Share of the operations' wall time in which the card ran no kernel
    and no copy."""
    tr = w.trace
    if tr is None or not tr.device:
        return None
    spans = tr.op_intervals(kind)
    total = iv.length(spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - iv.overlap(spans, tr.device_intervals()) / total)


def _device_entries(w, kind: str):
    """``(bytes_in, bytes_out)`` of every entry that took the device route
    (some kernel ran inside its codec phase, or inside its read), and the
    time in which kernels ran inside the operations (their union), in
    seconds."""
    tr = w.trace
    spans = tr.op_intervals(kind)
    ops = w.traced_ops(kind)
    if len(spans) != len(ops):
        return None, 0.0
    work = []
    if kind == "read":
        for (s, e), o in zip(spans, ops):
            if o.ok and tr.kernel_within(s, e):
                work.append((o.bytes_in, o.bytes_out))
    else:
        catalogs = iter(w.catalogs[len(w.catalogs) - sum(o.ok for o in ops):])
        codec = sorted((ps, pe) for n, ps, pe in tr.phases if n in CODEC_PHASES[kind])
        starts = [ps for ps, _ in codec]
        for (s, e), o in zip(spans, ops):
            if not o.ok:
                continue
            cat = next(catalogs)
            phases = [(ps, pe) for ps, pe in
                      codec[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
                      if pe <= e]
            if len(phases) != len(cat):
                return None, 0.0
            for (ps, pe), ent in zip(phases, cat):
                if tr.kernel_within(ps, pe):
                    work.append((ent.uncomp_size, ent.comp_size))
    kernels = [(a, b) for c, _, a, b in tr.device if c == "kernel"]
    busy = iv.overlap(spans, kernels) / 1e6
    return work, busy


def roofline_pct(w, kind: str) -> float | None:
    """The least time of the device-routed entries' bytes at the card's
    peak bandwidth over the kernels' time inside the operations."""
    if w.trace is None or not w.trace.device:
        return None
    work, busy = _device_entries(w, kind)
    if not work:
        return None
    return roofline.share_pct(roofline.work_bytes(work), busy)
