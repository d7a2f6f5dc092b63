"""`writer.xxh3` (the host XXH3-64 of each entry the Writer adds), host
ms per MB created."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["writer.xxh3"], "create")
