"""The benchmark's own device trace: ``torch.profiler`` over the measured
window, read back from its Chrome trace.

In a traced run every operation of the window is a ``record_function``
range named ``op:create`` or ``op:read``, and every phase the program
records in its ``metrics`` registry is also a range named ``phase:<name>``
(:func:`mirror_phases` wraps the registry's ``phase``; the program is not
changed).  The profiler puts those host ranges and the card's kernels and
copies on one clock, which is what the per-layer readers work from.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import tempfile
from dataclasses import dataclass, field

#: Chrome-trace categories of work on the card
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclass
class Trace:
    """Host ranges and device intervals of one traced window, in us."""

    ops: list = field(default_factory=list)      # (kind, start, end), in order
    phases: list = field(default_factory=list)   # (name, start, end)
    device: list = field(default_factory=list)   # (cat, name, start, end)
    _starts: list | None = field(default=None, repr=False)
    _maxend: list | None = field(default=None, repr=False)

    def window(self) -> tuple[float, float]:
        return self.ops[0][1], max(e for _, _, e in self.ops)

    def op_intervals(self, kind: str) -> list[tuple[float, float]]:
        return [(s, e) for k, s, e in self.ops if k == kind]

    def device_intervals(self) -> list[tuple[float, float]]:
        return [(s, e) for _, _, s, e in self.device]

    def kernel_within(self, s: float, e: float) -> bool:
        """Whether some kernel ran for part of ``(s, e)``."""
        if self._starts is None:
            ks = sorted((a, b) for c, _, a, b in self.device if c == "kernel")
            self._starts = [a for a, _ in ks]
            self._maxend = list(itertools.accumulate((b for _, b in ks), max))
        i = bisect.bisect_left(self._starts, e)
        return i > 0 and self._maxend[i - 1] > s


def mirror_phases(metrics, record_function):
    """Make each ``metrics.phase(name, nbytes)`` also a profiler range
    ``phase:<name>``.  Returns a function that undoes it."""
    orig = metrics.phase

    @contextlib.contextmanager
    def phase(name, nbytes=0):
        with record_function("phase:" + name), orig(name, nbytes):
            yield

    metrics.phase = phase
    return lambda: metrics.__dict__.pop("phase", None)


def parse(events) -> Trace:
    """A :class:`Trace` from Chrome-trace events (``traceEvents``)."""
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat in DEVICE_CATS:
            t.device.append((cat, name, s, e))
        elif cat == "user_annotation":
            if name.startswith("op:"):
                t.ops.append((name[3:], s, e))
            elif name.startswith("phase:"):
                t.phases.append((name[6:], s, e))
    t.ops.sort(key=lambda x: x[1])
    return t


class Profiler:
    """``torch.profiler`` of the host and, where there is one, the card.
    :meth:`prepare` sets the profiler up (for the card, several seconds of
    the tracing library's start) without recording; :meth:`start` begins
    recording; :meth:`stop` exports the Chrome trace to a temporary file,
    reads it into a :class:`Trace` and deletes the file."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # step 0 warms the profiler up, step 1 records
        self._prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1))

    def prepare(self) -> None:
        self._prof.__enter__()

    def start(self) -> None:
        self._prof.step()

    def stop(self) -> Trace:
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return parse(events)
