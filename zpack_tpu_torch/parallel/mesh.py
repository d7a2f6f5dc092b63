"""Device meshes: a 2-D ("entry", "block") grid of torch devices.

Counterpart of ``jax.sharding.Mesh`` as ``zpack_tpu/parallel/pipeline.py``
builds it (``make_mesh``).  A mesh is a plain list of devices in the order
of ``P("entry", "block")``: work is cut into contiguous row ranges, one a
device in that order, each range runs through the single-device path on
its device, and the results gather on the first device.  A device may
appear more than once ("cuda:0" twice is two shards on one card; ``["cpu"]
* 8`` is how the CPU tests run an 8-device mesh).
"""

from __future__ import annotations

import torch


class DeviceMesh:
    """A 2-D grid of torch devices with axes ("entry", "block")."""

    def __init__(self, grid: list[list[torch.device]]):
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.grid = [[torch.device(d) for d in row] for row in grid]
        self.shape = {"entry": len(grid), "block": len(grid[0])}

    @property
    def devices(self) -> list[torch.device]:
        """Every shard's device, in the order of ``P("entry", "block")``."""
        return [d for row in self.grid for d in row]

    @property
    def size(self) -> int:
        return self.shape["entry"] * self.shape["block"]

    def distinct(self) -> list[torch.device]:
        """The mesh's devices without repeats, in order of first shard."""
        return list(dict.fromkeys(self.devices))


def _resolve(device) -> torch.device:
    from ..codecs import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, entry_axis: int | None = None) -> DeviceMesh:
    """2-D mesh over ``devices`` (default: every visible CUDA device; raises
    RuntimeError without one): entries shard over the outer axis, blocks
    over the inner.  The entry axis is 4, else 2, where the device count is
    a multiple of it and at least twice it, else 1, the rule of the JAX
    ``make_mesh``; devices past ``entry * block`` are left out."""
    if devices is None:
        _resolve("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if entry_axis is None:
        entry_axis = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand * 2:
                entry_axis = cand
                break
    block_axis = n // entry_axis
    return DeviceMesh([devices[e * block_axis:(e + 1) * block_axis] for e in range(entry_axis)])


def as_mesh(device_or_mesh) -> DeviceMesh:
    """A mesh as it is; a device as a mesh of one."""
    if isinstance(device_or_mesh, DeviceMesh):
        return device_or_mesh
    return DeviceMesh([[torch.device(device_or_mesh)]])


def row_ranges(n: int, k: int) -> list[tuple[int, int]]:
    """``n`` rows over ``k`` shards: contiguous ranges of ``ceil(n / k)``
    rows in order, the last shorter and any after it empty, as the JAX
    wrappers' rows fall on the devices once padded to a multiple of ``k``."""
    per = -(-n // k)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(k)]
