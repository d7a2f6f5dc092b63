"""Share of zstd walks (`torch.zstd_walk`) whose read was enqueued on the
card from native code (`torch.zstd_enqueue`), in % of calls; 0 where every
read went through the kernels' Python wrappers, None where no zstd walk
ran."""


def read(w):
    walks = w.counter("torch.zstd_walk", "calls")
    if not walks:
        return None
    return 100.0 * (w.counter("torch.zstd_enqueue", "calls") or 0) / walks
