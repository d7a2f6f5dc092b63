"""Error model.

The reference exposes a flat ``zpack_result`` enum of 23 return codes
(reference: lib/zpack.h:189-218).  We keep the same machine-readable code
space (for API parity and for tests that assert specific failure kinds) but
surface failures the Python way, as exceptions carrying the code.
"""

from __future__ import annotations

import enum


class Result(enum.IntEnum):
    """Machine-readable result codes, 1:1 with the reference enum
    (reference: lib/zpack.h:189-218)."""

    OK = 0
    ERROR_ARCHIVE_NOT_LOADED = 1
    ERROR_WRITER_NOT_OPENED = 2
    ERROR_OPEN_FAILED = 3
    ERROR_SEEK_FAILED = 4
    ERROR_FILE_TOO_SMALL = 5
    ERROR_SIGNATURE_INVALID = 6
    ERROR_READ_FAILED = 7
    ERROR_BLOCK_SIZE_INVALID = 8
    ERROR_VERSION_INCOMPATIBLE = 9
    ERROR_MALLOC_FAILED = 10
    ERROR_FILE_NOT_FOUND = 11
    ERROR_BUFFER_TOO_SMALL = 12
    ERROR_DECOMPRESS_FAILED = 13
    ERROR_COMPRESS_FAILED = 14
    ERROR_FILE_HASH_MISMATCH = 15
    ERROR_FILE_OFFSET_INVALID = 16
    ERROR_FILE_INCOMPLETE = 17
    ERROR_FILE_SIZE_INVALID = 18
    ERROR_COMP_METHOD_INVALID = 19
    ERROR_WRITE_FAILED = 20
    ERROR_STREAM_INVALID = 21
    ERROR_HASH_FAILED = 22
    ERROR_FILENAME_TOO_LONG = 23
    ERROR_NOT_AVAILABLE = 24


class ZPackError(Exception):
    """Base exception; ``code`` is the :class:`Result` for this failure and
    ``last_return`` optionally carries a codec-internal detail value
    (mirroring reader/writer ``last_return``, reference: lib/zpack.h:100,158)."""

    def __init__(self, code: Result, message: str = "", last_return: int | None = None):
        self.code = Result(code)
        self.last_return = last_return
        super().__init__(message or self.code.name)


class SignatureError(ZPackError):
    def __init__(self, message: str = "invalid section signature"):
        super().__init__(Result.ERROR_SIGNATURE_INVALID, message)


class VersionError(ZPackError):
    def __init__(self, version: int):
        super().__init__(
            Result.ERROR_VERSION_INCOMPATIBLE, f"unsupported archive version {version}"
        )


class TruncatedError(ZPackError):
    def __init__(self, message: str = "unexpected end of data"):
        super().__init__(Result.ERROR_READ_FAILED, message)


class FileTooSmallError(ZPackError):
    def __init__(self, size: int):
        super().__init__(Result.ERROR_FILE_TOO_SMALL, f"{size} bytes is too small for an archive")


class BlockSizeError(ZPackError):
    def __init__(self, message: str = "invalid CDR block size"):
        super().__init__(Result.ERROR_BLOCK_SIZE_INVALID, message)


class FileNotFoundInArchiveError(ZPackError):
    def __init__(self, name: str):
        super().__init__(Result.ERROR_FILE_NOT_FOUND, f"file not found in archive: {name!r}")


class HashMismatchError(ZPackError):
    def __init__(self, expected: int, actual: int):
        super().__init__(
            Result.ERROR_FILE_HASH_MISMATCH,
            f"XXH3 mismatch: expected {expected:#018x}, got {actual:#018x}",
        )


class DecompressError(ZPackError):
    def __init__(self, message: str = "decompression failed", last_return: int | None = None):
        super().__init__(Result.ERROR_DECOMPRESS_FAILED, message, last_return)


class CompressError(ZPackError):
    def __init__(self, message: str = "compression failed", last_return: int | None = None):
        super().__init__(Result.ERROR_COMPRESS_FAILED, message, last_return)


class CompMethodError(ZPackError):
    def __init__(self, method: int):
        super().__init__(Result.ERROR_COMP_METHOD_INVALID, f"invalid compression method {method}")


class FilenameTooLongError(ZPackError):
    def __init__(self, length: int):
        super().__init__(
            Result.ERROR_FILENAME_TOO_LONG, f"filename length {length} exceeds 65535"
        )


class StreamStateError(ZPackError):
    def __init__(self, message: str = "invalid stream state"):
        super().__init__(Result.ERROR_STREAM_INVALID, message)
