"""Share of zstd walks (`torch.zstd_walk`) that ran the native walk
(`torch.zstd_walk.native`), in % of calls; 0 where the walk ran without it,
None where no zstd walk ran."""


def read(w):
    walks = w.counter("torch.zstd_walk", "calls")
    if not walks:
        return None
    return 100.0 * (w.counter("torch.zstd_walk.native", "calls") or 0) / walks
