"""`torch.zstd_walk` (the host walk of frame and block headers and tables),
host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.zstd_walk"], "read")
