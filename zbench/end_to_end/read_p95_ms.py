"""The 95th percentile (nearest rank) of the latency of every read of the
window, each ``read_file`` call one request."""

from zbench.intervals import p95


def read(w):
    lat = [o.t1 - o.t0 for o in w.ops_of("read")]
    return p95(lat) * 1e3 if lat else None
