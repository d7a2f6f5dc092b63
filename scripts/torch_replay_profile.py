#!/usr/bin/env python3
"""Time the sequence replay's kernels one by one on a GPU.

    python3 scripts/torch_replay_profile.py

Builds the 64 MiB corpus of ``chip_smoke.py``, records the replay's inputs
on the two shapes the port gives it (the 16 frame rows of the corpus as one
zstd entry, and the 1,024 rows of 64 KiB of the LZ4 main path), holds the
kernel against its plain version on both, and prints for each shape the
wrapper's time by CUDA events (mean of 10 calls) and, from
``torch.profiler``, each kernel's device time per call and the time of
every round launch in order.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch.kernels import fse_torch, huffman_torch, lz4_torch  # noqa: E402
from zpack_tpu_torch.parallel import extract  # noqa: E402
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor  # noqa: E402

CALLS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    modules = {"huffman_decode": huffman_torch, "fse_decode": fse_torch,
               "rep_totals": fse_torch, "rep_apply": fse_torch, "lz4_replay": lz4_torch}
    _, zcomp = cs.write_zstd_entry(corpus, dev, extract)
    with cs.recording_kernels(modules) as calls:
        if cs.zstd_python_route(extract, zcomp, len(corpus), dev) != corpus:
            raise AssertionError("the zstd entry does not decode to the corpus")
    zargs, zkw = calls["lz4_replay"][0]
    _, comp_blocks, bounds, _ = extract.walk_lz4f(DeviceCompressor(dev).compress(corpus))
    batch = lz4_torch.build_batch(comp_blocks, bounds)
    largs = [torch.from_numpy(batch[k]).to(dev) for k in lz4_torch.REPLAY_ARGS]
    for name, args, kw in (("zstd rows", zargs, zkw),
                           ("lz4 rows", largs, {"n_out": batch["n_out"]})):
        if not torch.equal(lz4_torch.replay(*args, **kw), lz4_torch.replay_plain(*args, **kw)):
            raise AssertionError(f"replay kernel != plain on the {name}")
        ms = cs.cuda_ms(lambda: lz4_torch.replay(*args, **kw), 10)
        print(f"{name} ({args[1].shape[0]} x {kw['n_out']} B): equal to plain, "
              f"replay {ms:.3f} ms a call")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                lz4_torch.replay(*args, **kw)
            torch.cuda.synchronize()
        rows = [(e.key, e.count // CALLS, e.device_time_total / CALLS / 1e3)
                for e in prof.key_averages() if "_kernel" in e.key]
        for key, count, kms in sorted(rows, key=lambda r: -r[2]):
            print(f"  {kms:8.3f} ms a call in {count:2d} launches  {key[:48]}")
        rounds = [e for e in prof.events() if "round_kernel" in e.name]
        print("  rounds of one call (us):",
              [round(e.device_time_total) for e in rounds[: len(rounds) // CALLS]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
