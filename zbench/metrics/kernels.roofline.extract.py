"""Least time of the device-routed reads (compressed bytes read once,
decoded bytes written once) at the peak of `zbench/roofline.py`, over the
kernels' time inside the reads (copies excluded), in percent."""

from zbench.layers import roofline_pct


def read(w):
    return roofline_pct(w, "read")
