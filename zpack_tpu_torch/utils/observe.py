"""Observability: per-phase timers/throughput counters and torch profiler
hooks.

The reference's only observability is printf progress lines and the
zpack_result code space (SURVEY.md §5).  Here every codec/pipeline phase
can record bytes+seconds into a process-global registry, and
:func:`trace` wraps a region in a ``torch.profiler`` trace (CPU and CUDA
activity, written as a Chrome trace) in which every phase is also a range.

Phases nest: each thread keeps the stack of its open phases, so a phase
knows its parent (the innermost phase open on its thread when it began)
and its self time (its time less that of the phases opened inside it).  A
phase whose name ends in ``.wait`` is one where the host blocks on the
device (an event or stream synchronisation, a device-to-host read, a
blocking copy); its bytes are those it brings to the host.  A count
(:meth:`Metrics.count`) is an event of no duration recorded the same way,
under the phase open when it happened: each hand-written kernel launch is
one, named ``launch.<kernel>`` (:func:`launched`; :func:`launches` reads
them back).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field


@dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    #: time less that of the phases opened inside it on the same thread
    self_seconds: float = 0.0
    #: calls by the name of the enclosing phase ("" at the top)
    parents: dict = field(default_factory=dict)

    @property
    def mbps(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0


class _Span:
    """One phase, open on its thread's stack while its ``with`` block runs."""

    __slots__ = ("_metrics", "name", "nbytes", "inner", "_parent", "_stack", "_range", "_t0")

    def __init__(self, metrics: "Metrics", name: str, nbytes: int):
        self._metrics = metrics
        self.name = name
        self.nbytes = nbytes
        self.inner = 0.0  # seconds of the phases closed inside it

    def __enter__(self):
        m = self._metrics
        try:
            stack = m._threads.stack
        except AttributeError:
            stack = m._threads.stack = []
        self._parent = stack[-1] if stack else None
        self._stack = stack
        stack.append(self)
        self._range = None
        if m._ranges is not None:
            self._range = m._ranges("phase:" + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        # a generator may close its phases out of order: take out this one
        stack = self._stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        parent = self._parent
        if parent is not None:
            parent.inner += dt
        up = "" if parent is None else parent.name
        m = self._metrics
        with m._lock:
            s = m._stats[self.name]
            s.calls += 1
            s.seconds += dt
            s.bytes += self.nbytes
            s.self_seconds += dt - self.inner
            s.parents[up] = s.parents.get(up, 0) + 1
        return False


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, PhaseStat] = defaultdict(PhaseStat)
        self._threads = threading.local()
        #: ``torch.profiler.record_function`` while :func:`trace` records
        self._ranges = None

    def phase(self, name: str, nbytes: int = 0) -> _Span:
        """A context manager that times its block as the phase ``name``
        and counts ``nbytes`` to it."""
        return _Span(self, name, nbytes)

    def count(self, name: str, n: int = 1, nbytes: int = 0) -> None:
        """Count ``n`` events of ``name`` (a kernel launch, say) and
        ``nbytes`` to it, under the phase open on this thread: a phase of no
        time, whose calls, bytes and parents add up as a span's do, and
        which leaves its parent's self time as it is."""
        stack = getattr(self._threads, "stack", None)
        up = stack[-1].name if stack else ""
        with self._lock:
            s = self._stats[name]
            s.calls += n
            s.bytes += nbytes
            s.parents[up] = s.parents.get(up, 0) + n

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"calls": v.calls, "seconds": round(v.seconds, 6),
                    "bytes": v.bytes, "MBps": round(v.mbps, 2),
                    "self_seconds": round(v.self_seconds, 6),
                    "parents": dict(v.parents)}
                for k, v in self._stats.items()
            }

    def report(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: process-global metrics registry
metrics = Metrics()


def launched(kernel: str) -> None:
    """Record one launch of the hand-written kernel ``kernel``: the count
    ``launch.<kernel>``, under the phase open on this thread."""
    metrics.count("launch." + kernel)


def launches(since: Counter | None = None) -> Counter:
    """Every kernel's launches in the registry, by kernel, less those of
    ``since`` (an earlier return of this function): the launches since that
    mark.  A kernel not launched reads 0."""
    now = Counter({k[len("launch."):]: s["calls"] for k, s in metrics.snapshot().items()
                   if k.startswith("launch.")})
    return now if since is None else now - since


@contextlib.contextmanager
def trace(dirname: str):
    """``torch.profiler`` trace around a region: host activity, the GPU's
    kernels and copies when one is visible, and every ``metrics`` phase of
    the region as a range ``phase:<name>`` on the same clock.  Writes
    ``<dirname>/trace.json`` (Chrome trace format) and yields ``dirname``.
    Outside this region a phase opens no profiler range."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        metrics._ranges = record_function
        try:
            yield dirname
        finally:
            metrics._ranges = None
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
