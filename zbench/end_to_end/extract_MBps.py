"""Bytes returned by every read of the window over the summed duration of
the extract spans: in a round trip the span from an archive's create to
its last read (the reader's open and every read), which with the creates
tiles the window; in an extract cell the whole window."""


def read(w):
    t = sum(e - s for s, e in w.extract_spans)
    n = sum(o.bytes_out for o in w.ops_of("read"))
    return n / t / 1e6 if n and t > 0 else None
