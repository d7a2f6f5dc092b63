"""Corpus generators, one module a kind, found by the kind's name."""
