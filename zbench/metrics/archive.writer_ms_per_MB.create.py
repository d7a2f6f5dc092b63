"""`writer.write_archive` + `writer.buffer` less the codec phases
(`lz4.compress`, `zstd.compress`) inside them, host ms per MB created: the
Writer's own work (records, host XXH3, the sink's copies), timed inside
the program."""

from zbench.spans import layer_ms_per_mb


def read(w):
    return layer_ms_per_mb(w, ["writer.write_archive", "writer.buffer"], "create")
