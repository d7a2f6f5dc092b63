"""`torch.serialize` (the native LZ4 serializer), host ms per MB created."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.serialize"], "create")
