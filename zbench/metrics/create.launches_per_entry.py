"""Hand-written kernel launches a device-routed LZ4 entry on create: the
program's `launch.*` counts whose chain of enclosing phases reaches
`writer.write_archive`, over the entries there that counted
`lz4.compress.device`; None where the program counts no launch or no
route."""

from zbench.per_entry import calls_per_device_create


def read(w):
    return calls_per_device_create(w, lambda name: name.startswith("launch."))
