"""Observability: per-phase timers/throughput counters and torch profiler
hooks.

The reference's only observability is printf progress lines and the
zpack_result code space (SURVEY.md §5).  Here every codec/pipeline phase
can record bytes+seconds into a process-global registry, and
:func:`trace` wraps a region in a ``torch.profiler`` trace (CPU and CUDA
activity, written as a Chrome trace).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def mbps(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, PhaseStat] = defaultdict(PhaseStat)

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stats[name]
                s.calls += 1
                s.seconds += dt
                s.bytes += nbytes

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"calls": v.calls, "seconds": round(v.seconds, 6),
                    "bytes": v.bytes, "MBps": round(v.mbps, 2)}
                for k, v in self._stats.items()
            }

    def report(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: process-global metrics registry
metrics = Metrics()


@contextlib.contextmanager
def trace(dirname: str):
    """``torch.profiler`` trace around a region: host activity, and the
    GPU's kernels and copies when one is visible.  Writes
    ``<dirname>/trace.json`` (Chrome trace format) and yields ``dirname``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield dirname
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
