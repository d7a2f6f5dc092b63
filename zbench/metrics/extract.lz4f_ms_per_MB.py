"""`torch.lz4f_walk` + `torch.lz4f_join` (the LZ4 frame walk and the join of
the pieces), host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.lz4f_walk", "torch.lz4f_join"], "read")
