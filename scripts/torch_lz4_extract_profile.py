#!/usr/bin/env python3
"""Split the LZ4 extract of the main path into its steps on a GPU.

    python3 scripts/torch_lz4_extract_profile.py

Writes the 64 MiB corpus of ``chip_smoke.py`` as one LZ4 level-1 entry with
the port's Writer (the GPU route), then runs the extract's steps as
``Reader.read_file`` runs them, each ended by a synchronisation, 7 times:
the frame walk (``extract.walk_lz4f``), the pinned pack of the compressed
blocks, their upload, the parse (``lz4_torch.parse_batch``: walk kernel,
read-back, layout kernel), the replay, the trim on the card
(``masked_select``), the pinned allocation and the download, the per-block
``tobytes``, the join, the XXH3 of the entry; then
``decompress_lz4f_batched`` and ``Reader.read_file`` whole.  Prints the
card's name and power limit first, then each step's median and range in ms.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer  # noqa: E402
from zpack_tpu_torch.codecs import xxh3 as H  # noqa: E402
from zpack_tpu_torch.kernels import _build, lz4_torch  # noqa: E402
from zpack_tpu_torch.parallel import extract  # noqa: E402

REPS = 7


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lz4_extract_profile: no CUDA GPU visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    _build.lib()
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    w = Writer.to_heap()
    w.write_archive([("bench.bin", corpus, CompressOptions(CompressionMethod.LZ4, 1))])
    r = Reader.from_memory(w.buffer, shared=True)
    e = r.get_file_entry("bench.bin")
    comp = bytes(w.buffer[e.offset:e.offset + e.comp_size])
    if r.read_file("bench.bin") != corpus:  # warm-up: every allocation made once
        raise AssertionError("the entry does not read back")
    steps: dict[str, list[float]] = {}

    def lap(name: str, t0: float) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps.setdefault(name, []).append((t - t0) * 1e3)
        return t

    for _ in range(REPS):
        torch.cuda.synchronize()
        t = t0 = time.perf_counter()
        pieces, blocks, bounds, spans = extract.walk_lz4f(comp)
        t = lap("walk_lz4f (host)", t)
        flat, offsets = lz4_torch.pack_blocks(blocks, pin=True)
        t = lap("pack into pinned memory", t)
        payload = flat.to(dev, non_blocking=True)
        t = lap("h2d of the compressed blocks", t)
        batch = lz4_torch.parse_batch(payload, offsets, bounds)
        t = lap("parse (walk, read-back, layout)", t)
        out = lz4_torch.replay(*(batch[k] for k in lz4_torch.REPLAY_ARGS), n_out=batch["n_out"])
        t = lap("replay", t)
        lens = batch["out_len_host"].astype(np.int64)
        keep = torch.arange(batch["n_out"], device=dev) < batch["out_len"][:len(blocks), None]
        kept = out[:len(blocks)].masked_select(keep)
        t = lap("trim on the card (masked_select)", t)
        host = torch.empty(int(lens.sum()), dtype=torch.uint8, pin_memory=True)
        t = lap("pinned allocation", t)
        host.copy_(kept)
        t = lap("d2h into pinned memory", t)
        view = host.numpy()
        ends = np.cumsum(lens)
        decoded = [view[a - n:a].tobytes() for a, n in zip(ends.tolist(), lens.tolist())]
        t = lap("per-block tobytes", t)
        data = b"".join(p[1] if p[0] == "raw" else decoded[p[1]] for p in pieces)
        t = lap("join of the pieces", t)
        if H.xxh3_64(data) != e.hash:
            raise AssertionError("XXH3 of the entry differs")
        t = lap("XXH3 of the entry (host)", t)
        lap("sum of the steps", t0)
        t0 = time.perf_counter()
        if extract.decompress_lz4f_batched(comp, len(corpus), device=dev) != corpus:
            raise AssertionError("decompress_lz4f_batched does not give the corpus back")
        t = lap("decompress_lz4f_batched as the path runs it", t0)
        if r.read_file("bench.bin") != corpus:
            raise AssertionError("read_file does not give the corpus back")
        lap("Reader.read_file as the path runs it", t)
    print(f"LZ4 extract split ({len(blocks)} compressed blocks of {len(pieces)} pieces, "
          f"{len(comp)} entry bytes, {len(corpus)} out; {REPS} runs, median [min, max] ms):")
    for name, ts in steps.items():
        print(f"  {name}: {statistics.median(ts):.3f} [{min(ts):.3f}, {max(ts):.3f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
