"""Device ms of the LZ4 match finder and block serializer (the kernels
named `tokenize_kernel`, `serialize_kernel` and `place_kernel` in the
trace: `csrc/lz4_tokenize.cu`, `csrc/lz4_serialize.cu`) inside the traced
creates, per MB those creates took in; None where the trace holds no
create or none of these kernels ran in one."""

import re

from zbench import intervals as iv

KERNELS = re.compile(r"\b(tokenize_kernel|serialize_kernel|place_kernel)\b")


def read(w):
    tr = w.trace
    if tr is None or not tr.ops:
        return None
    mb = sum(o.bytes_in for o in w.traced_ops("create") if o.ok) / 1e6
    spans = tr.op_intervals("create")
    kernels = [(s, e) for c, name, s, e in tr.device if c == "kernel" and KERNELS.search(name)]
    busy_ms = iv.overlap(spans, kernels) / 1e3
    if not mb or not busy_ms:
        return None
    return busy_ms / mb
