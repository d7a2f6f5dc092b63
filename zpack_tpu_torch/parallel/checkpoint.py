"""Checkpoint/resume for long compression jobs.

The reference has no checkpointing; its streaming API is merely resumable
mid-file by construction (SURVEY.md §5: state = zpack_stream + codec ctx).
For pod-scale jobs we persist a *per-block progress map*: each completed
block's compressed frame segment goes to a spool file with a JSON sidecar
recording (block index, offset, length, input hash); a restarted job
verifies the sidecar against the input and continues from the first
missing block.
"""

from __future__ import annotations

import json
import os
import pathlib

from ..codecs.xxh3 import xxh3_64


class CheckpointedCompressor:
    """Chunked, resumable compression of one large input to an lz4f/zstd
    multi-frame stream (chunk independence = resume granularity)."""

    def __init__(self, spool_path: str | os.PathLike, *, method: str = "lz4",
                 level: int = 1, chunk_size: int = 8 << 20):
        self.spool = pathlib.Path(spool_path)
        self.meta_path = self.spool.with_suffix(self.spool.suffix + ".progress.json")
        self.method = method
        self.level = level
        self.chunk_size = chunk_size

    def _compress_chunk(self, chunk: bytes) -> bytes:
        from ..codecs import get_codec
        from ..constants import CompressionMethod

        m = CompressionMethod.LZ4 if self.method == "lz4" else CompressionMethod.ZSTD
        return get_codec(m).compress(chunk, self.level)

    def _load_meta(self, input_hash: int, n_chunks: int) -> dict:
        if self.meta_path.exists() and self.spool.exists():
            try:
                meta = json.loads(self.meta_path.read_text())
                if (meta.get("input_hash") == f"{input_hash:#x}"
                        and meta.get("n_chunks") == n_chunks
                        and meta.get("method") == self.method
                        and meta.get("level") == self.level):
                    return meta
            except (json.JSONDecodeError, OSError):
                pass
        return {
            "input_hash": f"{input_hash:#x}",
            "n_chunks": n_chunks,
            "method": self.method,
            "level": self.level,
            "chunks": {},  # idx -> {offset, length}
        }

    def _save_meta(self, meta: dict) -> None:
        tmp = self.meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self.meta_path)

    def compress(self, data: bytes, *, fail_after: int | None = None) -> bytes:
        """Compress with per-chunk checkpointing; a rerun after a crash
        resumes at the first unfinished chunk.  ``fail_after`` (tests only)
        aborts after that many freshly compressed chunks."""
        data = bytes(data)
        n_chunks = max(1, -(-len(data) // self.chunk_size))
        input_hash = xxh3_64(data)
        meta = self._load_meta(input_hash, n_chunks)
        done = meta["chunks"]
        mode = "r+b" if self.spool.exists() and done else "w+b"
        fresh = 0
        with open(self.spool, mode) as spool:
            for i in range(n_chunks):
                key = str(i)
                if key in done:
                    continue
                chunk = data[i * self.chunk_size : (i + 1) * self.chunk_size]
                comp = self._compress_chunk(chunk)
                spool.seek(0, os.SEEK_END)
                offset = spool.tell()
                spool.write(comp)
                spool.flush()
                done[key] = {"offset": offset, "length": len(comp)}
                self._save_meta(meta)
                fresh += 1
                if fail_after is not None and fresh >= fail_after:
                    raise RuntimeError("injected failure for checkpoint test")
        # assemble in chunk order (spool order may differ after resumes)
        out = bytearray()
        with open(self.spool, "rb") as spool:
            for i in range(n_chunks):
                rec = done[str(i)]
                spool.seek(rec["offset"])
                out += spool.read(rec["length"])
        return bytes(out)

    def cleanup(self) -> None:
        for p in (self.spool, self.meta_path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
