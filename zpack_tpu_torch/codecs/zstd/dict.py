"""zstd dictionaries: parse (structured + raw-content), train, and attach.

The reference has no dictionary support anywhere (ZPack passes plain
ZSTD_compressCCtx / ZSTD_decompressDCtx, lib/zpack_write.c:179 /
lib/zpack_read.c:380); shared dictionaries are the BASELINE.json
north-star extension ("shared zstd dictionaries broadcast over ICI").

Structured dictionary wire format (RFC 8878 §5):

    magic 0xEC30A437 | dict_id (u32) | entropy tables | content

where the entropy tables are, in order: a Huffman table description
(literals), FSE table descriptions for offsets, match lengths and literal
lengths (same wire formats as inside compressed blocks), then the three
initial repeat offsets as u32 LE (each nonzero and <= content size).
Anything without the magic is a raw-content dictionary (prefix only).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ...errors import CompressError, DecompressError
from . import fse, huffman, seq

MAGIC = 0xEC30A437

#: dict_id ranges reserved by the spec (RFC 8878 §5): <= 32767 and >= 2^31
_ID_LOW_RESERVED = 32767
_ID_HIGH_RESERVED = 1 << 31


@dataclass
class ZstdDict:
    """A parsed dictionary: prefix content + optional initial entropy
    state (structured dicts only)."""

    dict_id: int
    content: bytes
    huf: "huffman.HuffDecodeTable | None" = None
    ll: "fse.DecodeTable | None" = None
    of: "fse.DecodeTable | None" = None
    ml: "fse.DecodeTable | None" = None
    rep: list[int] = field(default_factory=lambda: [1, 4, 8])
    raw: bytes = b""  # the original blob (what went over the wire)
    #: raw table materials kept for the encode side (structured dicts)
    huf_weights: "list[int] | None" = None
    fse_counts: "dict | None" = None  # kind -> (counts, al)

    def __len__(self) -> int:
        return len(self.content)

    def encode_tables(self):
        """Encode-side versions of the dict's entropy tables —
        (huf_enc, ll_enc, of_enc, ml_enc) — built from the SAME weights /
        normalized counts the decoder uses, so a first block can emit
        treeless literals + repeat-mode sequences (libzstd's dict
        repeat-mode, the ~5 B/frame header saving).  None for raw dicts."""
        if self.huf_weights is None or self.fse_counts is None:
            return None
        cached = getattr(self, "_enc_tables", None)
        if cached is not None:
            return cached
        import numpy as np

        w = np.array(self.huf_weights, dtype=np.int64)
        total = int((1 << np.maximum(w - 1, 0))[w > 0].sum())
        max_bits = total.bit_length() - 1
        codes, lengths = huffman._canonical_codes(w, max_bits)
        # pad to the full byte alphabet: _encode_stream indexes by symbol
        # (absent symbols keep length 0 and raise CompressError there)
        codes = np.pad(codes, (0, 256 - len(codes)))
        lengths = np.pad(lengths, (0, 256 - len(lengths)))
        huf_enc = huffman.HuffEncodeTable(
            max_bits=max_bits, codes=codes, lengths=lengths,
            weights=[int(x) for x in self.huf_weights])
        out = (huf_enc,
               fse.build_encode_table(*self.fse_counts["ll"]),
               fse.build_encode_table(*self.fse_counts["of"]),
               fse.build_encode_table(*self.fse_counts["ml"]))
        self._enc_tables = out
        return out


def parse_dictionary(blob: bytes) -> ZstdDict:
    """Parse a dictionary blob: structured if it carries the magic,
    raw-content otherwise (every byte string is a legal raw dict)."""
    blob = bytes(blob)
    if len(blob) < 8 or struct.unpack_from("<I", blob, 0)[0] != MAGIC:
        return ZstdDict(dict_id=0, content=blob, raw=blob)
    (dict_id,) = struct.unpack_from("<I", blob, 4)
    pos = 8
    try:
        weights, consumed = huffman.read_weights(blob, pos)
        huf = huffman.build_decode_table(weights)
        pos += consumed
        fse_counts = {}
        counts, al, c = fse.read_ncount(blob, pos, seq.OF_CODE_MAX, seq.OF_MAX_AL)
        of = fse.build_decode_table(counts, al)
        fse_counts["of"] = (counts, al)
        pos += c
        counts, al, c = fse.read_ncount(blob, pos, seq.ML_CODE_MAX, seq.ML_MAX_AL)
        ml = fse.build_decode_table(counts, al)
        fse_counts["ml"] = (counts, al)
        pos += c
        counts, al, c = fse.read_ncount(blob, pos, seq.LL_CODE_MAX, seq.LL_MAX_AL)
        ll = fse.build_decode_table(counts, al)
        fse_counts["ll"] = (counts, al)
        pos += c
    except (DecompressError, CompressError, IndexError, ValueError) as e:
        raise DecompressError(f"malformed dictionary entropy tables: {e}")
    if pos + 12 > len(blob):
        raise DecompressError("truncated dictionary repeat offsets")
    rep = list(struct.unpack_from("<III", blob, pos))
    pos += 12
    content = blob[pos:]
    for r in rep:
        if r == 0 or r > len(content):
            raise DecompressError("dictionary repeat offset out of range")
    return ZstdDict(dict_id=dict_id, content=content, huf=huf,
                    ll=ll, of=of, ml=ml, rep=rep, raw=blob,
                    huf_weights=weights, fse_counts=fse_counts)


def as_dictionary(obj) -> "ZstdDict | None":
    if obj is None or isinstance(obj, ZstdDict):
        return obj
    return parse_dictionary(obj)


# ---------------------------------------------------------------------------
# Training (COVER-lite)
# ---------------------------------------------------------------------------


def _select_content(samples: list[bytes], dict_size: int,
                    shingle: int = 16, segment: int = 64) -> bytes:
    """Greedy frequent-segment selection: score ``shingle``-byte windows by
    cross-sample frequency, keep the segments around the most frequent
    shingles.  Most frequent material goes at the END of the dictionary so
    it sits closest to the data (smallest offsets)."""
    counts: dict[bytes, list] = {}
    for si, s in enumerate(samples):
        if len(s) < shingle:
            continue
        step = max(1, shingle // 2)
        for i in range(0, len(s) - shingle + 1, step):
            key = bytes(s[i : i + shingle])
            ent = counts.get(key)
            if ent is None:
                counts[key] = [1, si, i]
            else:
                ent[0] += 1
    ranked = sorted(counts.items(), key=lambda kv: kv[1][0], reverse=True)
    chosen: list[bytes] = []
    seen: set[bytes] = set()
    total = 0
    for key, (cnt, si, i) in ranked:
        if cnt < 2 or total >= dict_size:
            break
        s = samples[si]
        lo = max(0, i - (segment - shingle) // 2)
        seg = bytes(s[lo : lo + segment])
        if seg in seen:
            continue
        seen.add(seg)
        chosen.append(seg)
        total += len(seg)
    if not chosen:
        # degenerate: no repeated shingles — use the tail of the largest sample
        big = max(samples, key=len, default=b"")
        return bytes(big[-dict_size:])
    chosen.reverse()  # most frequent last (nearest the data)
    out = b"".join(chosen)
    return out[-dict_size:]


def train_dictionary(samples: list[bytes], dict_size: int = 16 << 10,
                     dict_id: int | None = None) -> bytes:
    """Train a *structured* zstd dictionary from sample payloads.

    COVER-lite content selection + entropy tables derived from the sample
    statistics (Huffman from the byte histogram over all 256 symbols so any
    literal stays encodable; sequence FSE tables = the spec's predefined
    distributions written explicitly).  The result is a fully conformant
    dictionary: libzstd / python-zstandard load it directly.
    """
    samples = [bytes(s) for s in samples if len(s)]
    content = _select_content(samples, dict_size) if samples else b"\x00" * 8
    if len(content) < 8:
        content = (content + b"\x00" * 8)[:8]
    if dict_id is None:
        from ..xxh3 import xxh3_64

        span = _ID_HIGH_RESERVED - (_ID_LOW_RESERVED + 1)
        dict_id = _ID_LOW_RESERVED + 1 + (xxh3_64(content) % span)
    # Huffman literals table over the sample histogram; +1 everywhere keeps
    # all 256 symbols covered (a dict table must encode any future literal)
    hist = np.ones(256, dtype=np.int64)
    for s in samples:
        hist += np.bincount(np.frombuffer(s, dtype=np.uint8), minlength=256)
    table = huffman.build_encode_table(hist)
    tree = huffman.write_weights(table.weights)
    out = bytearray(struct.pack("<II", MAGIC, dict_id))
    out += tree
    out += fse.write_ncount(seq.OF_DEFAULT_DIST, seq.OF_DEFAULT_AL)
    out += fse.write_ncount(seq.ML_DEFAULT_DIST, seq.ML_DEFAULT_AL)
    out += fse.write_ncount(seq.LL_DEFAULT_DIST, seq.LL_DEFAULT_AL)
    reps = [min(r, len(content)) for r in (1, 4, 8)]
    out += struct.pack("<III", *reps)
    out += content
    return bytes(out)
