"""End-to-end metrics, one module a metric, found by the metric's name:
each ``read(window)`` returns the value or None."""
