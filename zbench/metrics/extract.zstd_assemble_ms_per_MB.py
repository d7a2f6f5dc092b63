"""`torch.zstd_assemble` + `torch.zstd_checksum`, host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.zstd_assemble", "torch.zstd_checksum"], "read")
