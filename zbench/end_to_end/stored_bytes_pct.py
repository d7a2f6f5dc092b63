"""Archive bytes (header, frames, CDR, EOCDR) over input bytes, x100, over
the archives the cell made (in the window, or the set-up's one)."""


def read(w):
    if not w.archives or not w.input_bytes:
        return None
    return 100.0 * sum(len(a) for a in w.archives) / (w.input_bytes * len(w.archives))
