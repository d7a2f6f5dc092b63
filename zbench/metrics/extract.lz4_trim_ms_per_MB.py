"""`torch.lz4_pack` + `torch.lz4_trim` (the blocks packed and uploaded, the
rows trimmed and downloaded), host ms per MB read."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.lz4_pack", "torch.lz4_trim"], "read")
