"""Places where the host blocks on the card, a read: the calls of every
`*.wait` phase whose chain of enclosing phases reaches `reader.read_file`,
over the calls of `reader.read_file`."""

from zbench.per_read import calls_per_read


def read(w):
    return calls_per_read(w, lambda name: name.endswith(".wait"))
