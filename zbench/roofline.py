"""The yardstick of the kernels' roofline shares: the card's published peak
and the work a layer needs, counted in bytes.

The archive's device work is bound by memory: a byte read, matched or
replayed and written takes a few integer operations, far under the card's
operation rate.  So the least time of a layer's device work is the bytes
it needs, each input byte read once and each output byte written once,
over the peak bandwidth.  The count depends on the work (the entries that
took the device route, their sizes in and out), not on which kernels do
it, so a kernel replaced or renamed leaves the yardstick as it is.
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA H100 data sheet),
#: stated for the card's full 700 W; a run prints the card's power limit
PEAK_BYTES_PER_S = 3.35e12


def work_bytes(entries) -> int:
    """Bytes the device work of ``entries`` needs: ``(bytes_in, bytes_out)``
    pairs, each byte read or written once."""
    return sum(int(i) + int(o) for i, o in entries)


def least_seconds(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S


def share_pct(nbytes: int, kernel_seconds: float) -> float | None:
    """The least time over the kernels' time, in percent; None where there
    is no work or no kernel time to compare (never 0 for a missing one)."""
    if nbytes <= 0 or kernel_seconds <= 0:
        return None
    return 100.0 * least_seconds(nbytes) / kernel_seconds
