"""Counts a read: the program's counts and phases whose chain of enclosing
phases reaches ``reader.read_file``, over that phase's calls.  A program
that records none of them, or no parents, gives nothing to read."""

from __future__ import annotations

from .spans import share_under

READ = "reader.read_file"


def calls_per_read(w, picked) -> float | None:
    """The calls of every counter whose name ``picked`` accepts, each
    weighted by the share of its calls made inside a read, over the reads'
    calls; None where no counter is picked or the reads carry no parents."""
    c = w.counters
    reads = c.get(READ)
    names = [n for n in c if picked(n)]
    if not names or not reads or not reads.get("calls") or "parents" not in reads:
        return None
    return sum(c[n]["calls"] * share_under(c, n, READ) for n in names) / reads["calls"]
