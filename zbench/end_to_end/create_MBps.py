"""Input bytes of every archive created in the window over the summed
duration of the creates (MB is 10^6 bytes)."""


def read(w):
    ops = w.ops_of("create")
    t = sum(o.t1 - o.t0 for o in ops)
    return sum(o.bytes_in for o in ops) / t / 1e6 if ops and t > 0 else None
