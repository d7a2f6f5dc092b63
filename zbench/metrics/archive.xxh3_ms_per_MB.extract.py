"""`reader.xxh3` (the host XXH3-64 check of each read), host ms per MB
read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["reader.xxh3"], "read")
