"""Frozen copy of the port's plain-Python zstd decoder (RFC 8878): bit
readers, FSE and Huffman tables, sequences, frames.  Dictionaries are left
out: no cell uses them."""
