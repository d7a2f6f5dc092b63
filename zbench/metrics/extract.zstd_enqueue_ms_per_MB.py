"""The zstd read's host enqueue: the self time (their `*.wait` children
excluded) of the phases that stage, size and launch it, whichever route
the read took (the Python wrappers' phases, or `torch.zstd_enqueue` of the
native chain), host ms per MB read."""

from zbench.layers import mb

PHASES = ("torch.zstd_stage", "torch.huffman_decode", "torch.fse_decode", "torch.rep_resolve",
          "torch.zstd_assemble", "torch.replay", "torch.zstd_enqueue")


def read(w):
    secs = [w.counter(p, "self_seconds") for p in PHASES]
    if all(s is None for s in secs) or not mb(w, "read"):
        return None
    return 1e3 * sum(s for s in secs if s is not None) / mb(w, "read")
