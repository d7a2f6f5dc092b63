"""Least time of the device-routed entries (input read once, compressed
bytes written once) at the peak of `zbench/roofline.py`, over the kernels'
time inside the creates (copies excluded), in percent."""

from zbench.layers import roofline_pct


def read(w):
    return roofline_pct(w, "create")
