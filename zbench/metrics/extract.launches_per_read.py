"""Hand-written kernel launches a read: the program's `launch.*` counts
whose chain of enclosing phases reaches `reader.read_file`, over the calls
of `reader.read_file`; None where the program counts no launch."""

from zbench.per_read import calls_per_read


def read(w):
    return calls_per_read(w, lambda name: name.startswith("launch."))
