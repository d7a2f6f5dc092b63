"""`zstd.decompress` (the codec phase of a zstd entry, whichever route it
took), host ms a call."""


def read(w):
    calls = w.counter("zstd.decompress", "calls")
    if not calls:
        return None
    return 1e3 * w.counter("zstd.decompress") / calls
