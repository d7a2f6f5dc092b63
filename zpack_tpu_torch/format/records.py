"""On-disk record structures and their little-endian serialization.

Byte layouts follow the ZPack v1 spec exactly (reference: docs/specs.md,
sections "Archive header" / "File data" / "Central directory record" /
"End of central directory record"; parser behavior modeled on
lib/zpack_read.c:33-223 and writers on lib/zpack_write.c:60-128,687-816).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .. import constants as C
from ..errors import (
    BlockSizeError,
    FilenameTooLongError,
    SignatureError,
    TruncatedError,
    VersionError,
)

_LE16 = struct.Struct("<H")
_LE32 = struct.Struct("<I")
_LE64 = struct.Struct("<Q")
_HEADER = struct.Struct("<IH")  # signature, version
_CDR_HEADER = struct.Struct("<IQQ")  # signature, file_count, block_size
_ENTRY_FIXED_TAIL = struct.Struct("<QQQQB")  # offset, comp, uncomp, hash, method
_EOCDR = struct.Struct("<IQ")  # signature, cdr_offset


@dataclass
class FileEntry:
    """One central-directory entry (reference: lib/zpack.h:71-80 and
    docs/specs.md CDR entry table).

    ``filename`` is stored UTF-8 on disk with '/' separators; ``hash`` is the
    XXH3-64 of the *uncompressed* data.
    """

    filename: str
    offset: int = 0
    comp_size: int = 0
    uncomp_size: int = 0
    hash: int = 0
    comp_method: int = C.CompressionMethod.NONE

    def encoded_name(self) -> bytes:
        return self.filename.encode("utf-8")

    def disk_size(self) -> int:
        """Bytes this entry occupies inside the CDR block."""
        return C.FILE_ENTRY_FIXED_SIZE + len(self.encoded_name())

    def serialize(self) -> bytes:
        name = self.encoded_name()
        if len(name) > C.MAX_FILENAME_LENGTH:
            raise FilenameTooLongError(len(name))
        return (
            _LE16.pack(len(name))
            + name
            + _ENTRY_FIXED_TAIL.pack(
                self.offset, self.comp_size, self.uncomp_size, self.hash, self.comp_method
            )
        )


@dataclass
class CDR:
    """Central directory record: header + packed entries."""

    entries: list[FileEntry] = field(default_factory=list)

    @property
    def file_count(self) -> int:
        return len(self.entries)

    def block_size(self) -> int:
        return sum(e.disk_size() for e in self.entries)

    def serialize(self) -> bytes:
        body = b"".join(e.serialize() for e in self.entries)
        return _CDR_HEADER.pack(C.CDR_SIGNATURE, len(self.entries), len(body)) + body


def serialize_header(version: int = C.ARCHIVE_VERSION) -> bytes:
    """Archive header (docs/specs.md "Archive header"; writer parity:
    lib/zpack_write.c:60-67)."""
    return _HEADER.pack(C.HEADER_SIGNATURE, version)


def serialize_data_header() -> bytes:
    """File-data section signature (docs/specs.md "File data")."""
    return _LE32.pack(C.DATA_SIGNATURE)


def serialize_eocdr(cdr_offset: int) -> bytes:
    return _EOCDR.pack(C.EOCDR_SIGNATURE, cdr_offset)


def parse_header(buf: bytes | memoryview, offset: int = 0) -> int:
    """Validate the archive header, return the archive version.

    Parity: zpack_read_header_memory (lib/zpack_read.c:33-43) — signature
    check then version-range check.
    """
    if len(buf) - offset < C.HEADER_SIZE:
        raise TruncatedError("archive header truncated")
    sig, version = _HEADER.unpack_from(buf, offset)
    if sig != C.HEADER_SIGNATURE:
        raise SignatureError("bad archive header signature")
    if not (C.ARCHIVE_VERSION_MIN <= version <= C.ARCHIVE_VERSION_MAX):
        raise VersionError(version)
    return version


def parse_data_header(buf: bytes | memoryview, offset: int = C.HEADER_SIZE) -> None:
    """Validate the file-data signature right after the header
    (parity: lib/zpack_read.c:57-63)."""
    if len(buf) - offset < C.SIGNATURE_SIZE:
        raise TruncatedError("data header truncated")
    (sig,) = _LE32.unpack_from(buf, offset)
    if sig != C.DATA_SIGNATURE:
        raise SignatureError("bad file-data signature")


def parse_eocdr(buf: bytes | memoryview, offset: int) -> int:
    """Parse the EOCDR at ``offset`` (normally file_size - 12), return the
    CDR offset (parity: lib/zpack_read.c:78-85)."""
    if len(buf) - offset < C.EOCDR_SIZE:
        raise TruncatedError("EOCDR truncated")
    sig, cdr_offset = _EOCDR.unpack_from(buf, offset)
    if sig != C.EOCDR_SIGNATURE:
        raise SignatureError("bad EOCDR signature")
    return cdr_offset


def parse_cdr_header(buf: bytes | memoryview, offset: int) -> tuple[int, int]:
    """Parse the CDR header, return (file_count, block_size)
    (parity: lib/zpack_read.c:87-107)."""
    if len(buf) - offset < C.CDR_HEADER_SIZE:
        raise TruncatedError("CDR header truncated")
    sig, file_count, block_size = _CDR_HEADER.unpack_from(buf, offset)
    if sig != C.CDR_SIGNATURE:
        raise SignatureError("bad CDR signature")
    return file_count, block_size


def parse_file_entries(
    block: bytes | memoryview, file_count: int
) -> tuple[list[FileEntry], int, int]:
    """Parse ``file_count`` entries out of a CDR block.

    Returns (entries, total_comp_size, total_uncomp_size).  Bounds are
    enforced with a remaining-block-size countdown exactly like the reference
    hot loop (lib/zpack_read.c:109-163): every entry must fit in what is left
    of the declared block, otherwise the block size is invalid.
    """
    entries: list[FileEntry] = []
    pos = 0
    left = len(block)
    total_comp = 0
    total_uncomp = 0
    mv = memoryview(block)
    for _ in range(file_count):
        if left < C.FILE_ENTRY_FIXED_SIZE:
            raise BlockSizeError("CDR block too small for declared entry count")
        (name_len,) = _LE16.unpack_from(mv, pos)
        if left < C.FILE_ENTRY_FIXED_SIZE + name_len:
            raise BlockSizeError("file entry overruns CDR block")
        name = bytes(mv[pos + 2 : pos + 2 + name_len]).decode("utf-8", errors="surrogateescape")
        off, comp, uncomp, hsh, method = _ENTRY_FIXED_TAIL.unpack_from(mv, pos + 2 + name_len)
        entries.append(
            FileEntry(
                filename=name,
                offset=off,
                comp_size=comp,
                uncomp_size=uncomp,
                hash=hsh,
                comp_method=method,
            )
        )
        consumed = C.FILE_ENTRY_FIXED_SIZE + name_len
        pos += consumed
        left -= consumed
        total_comp += comp
        total_uncomp += uncomp
    return entries, total_comp, total_uncomp
