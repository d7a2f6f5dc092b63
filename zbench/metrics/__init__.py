"""Per-layer metrics, one module a metric, found by the metric's name:
each ``read(window)`` returns the value, or None where the traced run holds
nothing to read it from."""
