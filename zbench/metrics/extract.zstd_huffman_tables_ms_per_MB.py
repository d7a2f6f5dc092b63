"""`torch.zstd_walk.literals` (each block's literals section header and
Huffman table, read by the host walk), host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.zstd_walk.literals"], "read")
