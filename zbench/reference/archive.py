"""ZPack v1 records, read independently of the program (docs/specs.md):

    header   u32 0x154B505A, u16 version (1)
    data     u32 0x144B505A, then the entries' compressed bytes
    CDR      u32 0x134B505A, u64 file count, u64 block size, then per entry
             u16 name length, name, u64 offset, u64 compressed size,
             u64 uncompressed size, u64 XXH3-64, u8 method
    EOCDR    u32 0x124B505A, u64 CDR offset (the last 12 bytes)
"""

from __future__ import annotations

import struct
from typing import NamedTuple

HEADER_SIG = 0x154B505A
DATA_SIG = 0x144B505A
CDR_SIG = 0x134B505A
EOCDR_SIG = 0x124B505A
DATA_START = 10


class Entry(NamedTuple):
    name: str
    offset: int
    comp_size: int
    uncomp_size: int
    hash: int
    method: int


def parse(buf: bytes) -> tuple[list[Entry], list[str]]:
    """The entries and a list of what is wrong with the records (empty when
    the header, the data signature, the CDR, the EOCDR and the entries'
    layout are sound: entries back to back from byte 10 up to the CDR)."""
    faults: list[str] = []
    n = len(buf)
    if n < DATA_START + 20 + 12:
        return [], [f"archive of {n} bytes is too short"]
    sig, version = struct.unpack_from("<IH", buf, 0)
    if sig != HEADER_SIG:
        faults.append("header signature")
    if version != 1:
        faults.append(f"version {version}")
    if struct.unpack_from("<I", buf, 6)[0] != DATA_SIG:
        faults.append("data signature")
    sig, cdr_off = struct.unpack_from("<IQ", buf, n - 12)
    if sig != EOCDR_SIG:
        faults.append("EOCDR signature")
    if not DATA_START <= cdr_off <= n - 12 - 20:
        return [], faults + [f"CDR offset {cdr_off} outside the archive"]
    sig, count, block = struct.unpack_from("<IQQ", buf, cdr_off)
    if sig != CDR_SIG:
        faults.append("CDR signature")
    if cdr_off + 20 + block != n - 12:
        faults.append(f"CDR block of {block} bytes does not end at the EOCDR")
    entries: list[Entry] = []
    pos = cdr_off + 20
    end = min(n - 12, cdr_off + 20 + block)
    for _ in range(count):
        if pos + 2 > end:
            faults.append("CDR entries overrun the block")
            break
        (nlen,) = struct.unpack_from("<H", buf, pos)
        if pos + 2 + nlen + 33 > end:
            faults.append("CDR entries overrun the block")
            break
        name = buf[pos + 2:pos + 2 + nlen].decode("utf-8", "replace")
        off, comp, uncomp, h, method = struct.unpack_from("<QQQQB", buf, pos + 2 + nlen)
        entries.append(Entry(name, off, comp, uncomp, h, method))
        pos += 2 + nlen + 33
    if pos != end:
        faults.append("CDR block holds bytes after its entries")
    expect = DATA_START
    for e in entries:
        if e.offset != expect:
            faults.append(f"entry {e.name} at {e.offset}, expected {expect}")
        expect = e.offset + e.comp_size
    if expect != cdr_off:
        faults.append(f"entries end at {expect}, the CDR starts at {cdr_off}")
    return entries, faults
