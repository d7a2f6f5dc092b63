"""Read spans minus the codec phases (`lz4.decompress`, `zstd.decompress`,
whichever route opened them) inside them, ms per MB read: the Reader,
its copies and the XXH3 check."""

from zbench.layers import self_ms_per_mb


def read(w):
    return self_ms_per_mb(w, "read")
