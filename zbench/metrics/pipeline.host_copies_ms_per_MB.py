"""`torch.stage` + `torch.frame` (the zero-filled step and its copy of the
input; the slices of the input, the frame's growth and its final copy),
host ms per MB created."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.stage", "torch.frame"], "create")
