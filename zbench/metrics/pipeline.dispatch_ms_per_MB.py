"""`torch.dispatch` + `torch.d2h` (tokenizer launch and wire-format
download), host ms per MB created."""

from zbench.layers import ms_per_mb


def read(w):
    return ms_per_mb(w, ["torch.dispatch", "torch.d2h"], "create")
