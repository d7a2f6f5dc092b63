"""Share of the bytes the LZ4 shards of creates serialized on the card
(`lz4.serialize.device` bytes over those of `lz4.serialize.device` and
`lz4.serialize.host`, the counts each shard makes under `torch.serialize`),
in percent; None where the program counts no serializer route."""


def read(w):
    device, host = (w.counter(f"lz4.serialize.{r}", "bytes") or 0 for r in ("device", "host"))
    return 100.0 * device / (device + host) if device + host else None
