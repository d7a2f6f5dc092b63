"""The reference's own error classes."""


class DecompressError(ValueError):
    """Malformed or inconsistent compressed data."""


class CompressError(ValueError):
    """An encoder step was handed input it cannot code (unused by the
    decoders; kept so the frozen copies import unchanged)."""
