"""ZPack file-format constants.

Format constants follow the ZPack v1 on-disk specification
(reference: docs/specs.md; lib/zpack.h:36-52) so that archives we emit are
bit-compatible with the reference reader and vice versa.
"""

from __future__ import annotations

import enum

# Section signatures (little-endian u32 on disk; ASCII "ZPK" + a version byte).
# reference: lib/zpack.h:36-39
HEADER_SIGNATURE = 0x154B505A  # "ZPK\x15"
DATA_SIGNATURE = 0x144B505A  # "ZPK\x14"
CDR_SIGNATURE = 0x134B505A  # "ZPK\x13"
EOCDR_SIGNATURE = 0x124B505A  # "ZPK\x12"

# Fixed section sizes in bytes.  reference: lib/zpack.h:41-46
SIGNATURE_SIZE = 4
HEADER_SIZE = 6  # signature(4) + version(2)
CDR_HEADER_SIZE = 20  # signature(4) + file_count(8) + block_size(8)
FILE_ENTRY_FIXED_SIZE = 35  # filename_len(2)+offset(8)+comp(8)+uncomp(8)+hash(8)+method(1)
EOCDR_SIZE = 12  # signature(4) + cdr_offset(8)
MINIMUM_ARCHIVE_SIZE = HEADER_SIZE + SIGNATURE_SIZE + CDR_HEADER_SIZE + EOCDR_SIZE

MAX_FILENAME_LENGTH = 65535  # reference: lib/zpack.h:48

# Archive format versions we can read/write.  reference: lib/zpack.h:50-52
ARCHIVE_VERSION_MIN = 1
ARCHIVE_VERSION_MAX = 1
ARCHIVE_VERSION = 1


class CompressionMethod(enum.IntEnum):
    """On-disk compression-method ids.  reference: lib/zpack.h:59-65."""

    NONE = 0
    ZSTD = 1
    LZ4 = 2  # LZ4 *frame* format (lz4f) per docs/specs.md "Note"


#: Default compression levels per method, mirroring the reference CLI defaults
#: (reference: programs/args.c:107-119 — zstd:3, lz4:1 via "-m method:level").
DEFAULT_LEVELS = {
    CompressionMethod.NONE: 0,
    CompressionMethod.ZSTD: 3,
    CompressionMethod.LZ4: 1,
}

#: Well-known entry name carrying a shared zstd dictionary (stored
#: uncompressed).  This is a zpack-tpu extension — the reference has no
#: dictionary support (plain ZSTD_compressCCtx, lib/zpack_write.c:179);
#: archives without this entry are byte-compatible with the reference.
DICT_ENTRY_NAME = "__zpack.dict"
