"""Share of the bytes `lz4.compress` saw that LZ4's high-compression mode
took (`lz4.compress.hc` bytes: each shard the card's HC parse serialized,
each entry the host encoder wrote at level 3 or more), in percent; None
where the program counts no such bytes or compressed no LZ4 entry."""


def read(w):
    seen = w.counter("lz4.compress", "bytes")
    hc = w.counter("lz4.compress.hc", "bytes")
    if not seen or hc is None:
        return None
    return 100.0 * hc / seen
