"""Arithmetic over the parents the program's registry records
(``utils/observe.metrics``): each phase of the window's counters carries
``parents``, its calls by the name of the phase open around it ("" at the
top).  A program whose registry records no parents gives these readers
nothing to read, and they return None."""

from __future__ import annotations

from .layers import CODEC_PHASES, mb


def share_under(counters: dict, name: str, root: str, _seen: tuple = ()) -> float:
    """The share of ``name``'s calls whose chain of enclosing phases
    reaches ``root``: each parent's calls, weighted by that parent's own
    share."""
    if name == root:
        return 1.0
    c = counters.get(name)
    if not c or not c.get("calls") or name in _seen:
        return 0.0
    return sum(n * share_under(counters, p, root, _seen + (name,))
               for p, n in (c.get("parents") or {}).items() if p) / c["calls"]


def _recorded(w, root: str) -> bool:
    return root in w.counters and "parents" in w.counters[root]


def layer_ms_per_mb(w, tops, kind: str) -> float | None:
    """The phases ``tops`` (the first one required) less the codec phases
    inside them, host ms per MB of ``kind``: the archive layer's own work."""
    c = w.counters
    if not _recorded(w, tops[0]) or not mb(w, kind):
        return None
    secs = 0.0
    for top in tops:
        if top in c:
            secs += c[top]["seconds"] - sum(c[p]["seconds"] * share_under(c, p, top)
                                            for p in CODEC_PHASES[kind] if p in c)
    return 1e3 * secs / mb(w, kind)


def wait_ms_per_mb(w, root: str, kind: str) -> float | None:
    """Every ``*.wait`` phase (the host blocked on the card) whose chain of
    enclosing phases reaches ``root``, host ms per MB of ``kind``."""
    c = w.counters
    if not _recorded(w, root) or not mb(w, kind):
        return None
    secs = sum(v["seconds"] * share_under(c, n, root) for n, v in c.items() if n.endswith(".wait"))
    return 1e3 * secs / mb(w, kind)
