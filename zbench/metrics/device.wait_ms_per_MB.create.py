"""Every `*.wait` phase (the host blocked on the card: an event, a
read-back, a blocking copy) inside `writer.write_archive`, host ms per MB
created."""

from zbench.spans import wait_ms_per_mb


def read(w):
    return wait_ms_per_mb(w, "writer.write_archive", "create")
