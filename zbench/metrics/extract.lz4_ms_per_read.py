"""`lz4.decompress` (the codec phase of an LZ4 entry, whichever route it
took, the Reader's in-place decode included) inside `reader.read_file`,
host ms a call: the whole cost of decoding an entry."""

from zbench.per_entry import ms_per_call
from zbench.per_read import READ


def read(w):
    return ms_per_call(w, "lz4.decompress", READ)
