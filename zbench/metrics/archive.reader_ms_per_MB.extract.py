"""`reader.read_file` + `reader.open` less the codec phases
(`lz4.decompress`, `zstd.decompress`) inside them, host ms per MB read: the
Reader's own work (the entry's slice, the XXH3 check, the frame scan),
timed inside the program."""

from zbench.spans import layer_ms_per_mb


def read(w):
    return layer_ms_per_mb(w, ["reader.read_file", "reader.open"], "read")
