"""Create spans minus the codec phases (`lz4.compress`, `zstd.compress`)
inside them, ms per MB created: the Writer, the host XXH3 and the sink."""

from zbench.layers import self_ms_per_mb


def read(w):
    return self_ms_per_mb(w, "create")
