"""`torch.zstd_walk.sequences` (each block's sequences section header and
FSE tables, read by the host walk), host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.zstd_walk.sequences"], "read")
