"""Share of the bytes `lz4.compress` saw that took the device route
(`torch.dispatch` bytes), in percent."""


def read(w):
    seen = w.counter("lz4.compress", "bytes")
    dev = w.counter("torch.dispatch", "bytes")
    if not seen:
        return None
    return 100.0 * (dev or 0) / seen
