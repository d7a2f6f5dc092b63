"""Every `*.wait` phase (the host blocked on the card: an event, a
read-back, a blocking copy) inside `reader.read_file`, host ms per MB
read."""

from zbench.spans import wait_ms_per_mb


def read(w):
    return wait_ms_per_mb(w, "reader.read_file", "read")
