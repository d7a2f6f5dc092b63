"""Process start to window start: imports, the card, the kernels and the
native library, the corpus, the set-up archive, the warm-up pass."""


def read(w):
    return w.setup_s
