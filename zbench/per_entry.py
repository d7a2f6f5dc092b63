"""Counts and times an LZ4 entry, on create and on read: the program's
phases and counts whose chain of enclosing phases reaches
``writer.write_archive`` (a create) or ``reader.read_file`` (a read),
weighted as :func:`zbench.spans.share_under` weighs them.  The codec
counts each entry's route (``lz4.compress.device``, ``lz4.compress.host``,
``lz4.decompress.device``, ``lz4.decompress.host``); a program that
counts no route, or records no parents, gives nothing to read."""

from __future__ import annotations

from .spans import share_under

WRITE = "writer.write_archive"


def under(w, name: str, root: str, key: str = "calls") -> float:
    """``key`` of ``name`` (its calls, or its seconds) inside ``root``; 0
    where the program recorded no ``name``, no ``root`` or no parents."""
    c = w.counters.get(name)
    if not c or "parents" not in c or root not in w.counters:
        return 0.0
    return c[key] * share_under(w.counters, name, root)


def ms_per_call(w, phase: str, root: str) -> float | None:
    """Host ms a call of ``phase`` inside ``root``."""
    calls = under(w, phase, root)
    return 1e3 * under(w, phase, root, "seconds") / calls if calls else None


def calls_per_device_create(w, picked) -> float | None:
    """The calls inside creates of every counter whose name ``picked``
    accepts, over the LZ4 entries there that took the device route; None
    where no counter is picked or no entry took that route."""
    entries = under(w, "lz4.compress.device", WRITE)
    names = [n for n in w.counters if picked(n)]
    if not names or not entries:
        return None
    return sum(under(w, n, WRITE) for n in names) / entries
