"""Share of the creates' wall time in which the card ran no kernel and no
copy, from the union of the profiler's device intervals, in percent."""

from zbench.layers import idle_pct


def read(w):
    return idle_pct(w, "create")
