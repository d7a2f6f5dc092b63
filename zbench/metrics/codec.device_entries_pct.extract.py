"""Share of the LZ4 reads (`lz4.decompress.device` and `lz4.decompress.host`
counts inside `reader.read_file`) that took the device route, in percent;
None where the program counts no route."""

from zbench.per_entry import under
from zbench.per_read import READ


def read(w):
    device, host = (under(w, f"lz4.decompress.{r}", READ) for r in ("device", "host"))
    return 100.0 * device / (device + host) if device + host else None
