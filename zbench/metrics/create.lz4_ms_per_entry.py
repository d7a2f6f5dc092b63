"""`lz4.compress` (the codec phase of an LZ4 entry, whichever route it
took) inside `writer.write_archive`, host ms a call: the whole cost of
compressing an entry."""

from zbench.per_entry import WRITE, ms_per_call


def read(w):
    return ms_per_call(w, "lz4.compress", WRITE)
