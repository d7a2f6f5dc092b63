"""Dry run of the mesh paths: the twin of ``__graft_entry__.dryrun_multichip``.

The same shapes and assertions on a :class:`DeviceMesh` of torch devices:
the LZ4 round trip over more than one mesh step with a ragged tail and an
uneven last shard, the zstd pipeline, the dictionary broadcast at 8 KiB
blocks, and the mesh extraction.
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every mesh path on ``make_mesh(devices)``, or on the first
    ``n_devices`` visible cards; raises AssertionError on a wrong round trip
    (and RuntimeError with fewer cards than asked for)."""
    from ..codecs.lz4 import frame as lz4frame
    from ..codecs.zstd import frame as zstdframe
    from ..codecs.zstd.dict import train_dictionary
    from .extract import decompress_zstd_device
    from .pipeline import DeviceCompressor, make_mesh

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    mesh = make_mesh(list(devices)[:n_devices])

    # production 64 KiB blocks, more than one mesh step of data, a ragged
    # tail block and an uneven last shard (a block count that is no multiple
    # of the shards)
    dc = DeviceCompressor(mesh)
    rng = np.random.default_rng(1)
    n = 2 * mesh.size * DeviceCompressor.BYTES_PER_STEP + 190_001
    data = bytes(
        np.where(
            rng.random(n) < 0.8,
            np.tile(np.frombuffer(b"multichip", dtype=np.uint8), n // 9 + 1)[:n],
            rng.integers(0, 256, n),
        ).astype(np.uint8)
    )
    comp = dc.compress(data)
    if lz4frame.decompress_frame(comp) != data:
        raise AssertionError("multichip mesh compression round-trip failed")

    # zstd mesh pipeline: a smaller span (host entropy work is the slow
    # stage) but still a ragged tail and an uneven shard
    zdata = data[: 3 * (64 << 10) * mesh.size + 77_777]
    zcomp = dc.compress_zstd(zdata, 3)
    if zstdframe.decompress(zcomp) != zdata:
        raise AssertionError("multichip zstd pipeline round-trip failed")

    # the shared dictionary, copied to every mesh device, one
    # dictionary-referencing frame per block
    dcd = DeviceCompressor(mesh, block_size=8192)
    ddata = data[: 8192 * 2 * mesh.size + 4_321]
    blob = train_dictionary([ddata[i : i + 512] for i in range(0, 8192, 512)], 2048)
    dcomp = dcd.compress_zstd(ddata, 3, dictionary=blob)
    if zstdframe.decompress(dcomp, dictionary=blob) != ddata:
        raise AssertionError("multichip dict-broadcast round-trip failed")

    # mesh extraction: the device zstd decode with its stream and block
    # batches sharded over the same mesh
    if decompress_zstd_device(zcomp, len(zdata), device=mesh.devices[0], mesh=mesh) != zdata:
        raise AssertionError("multichip mesh extraction round-trip failed")
