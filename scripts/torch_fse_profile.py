#!/usr/bin/env python3
"""Time the FSE sequence decoder at the zstd extract shape on a GPU.

    python3 scripts/torch_fse_profile.py [SOURCE.cu ...]

Writes the 64 MiB corpus of ``chip_smoke.py`` as one zstd level-3 entry,
records the inputs of the sequence decode of one read through the kernels'
Python wrappers (``chip_smoke.zstd_python_route``), and for each source (by default the repo's
``zpack_tpu_torch/csrc/fse_decode.cu``; more copies to compare variants,
each with the C entry point ``zp_fse_decode`` of the repo's) compiles it
alone, holds its outputs against ``decode_seq_streams_plain`` (exact), and
times its launches by CUDA events (mean of 20), in the order given and
then in reverse, so that two sources are timed A, B, B, A in one process.
The launch is timed alone: the wrapper's read-back of the batch's sizes
and its allocations are outside.  Prints the card's name and power limit
first, then per source and round the ms a launch and the ns a step of the
longest block's chain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch.kernels import _build, fse_torch, huffman_torch, lz4_torch  # noqa: E402
from zpack_tpu_torch.parallel import extract  # noqa: E402

REPS = 20


def build(tmp: str, k: int, src: str):
    so = os.path.join(tmp, f"fse_decode_{k}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                   check=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zp_fse_decode.restype = i
    lib.zp_fse_decode.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, i, p, p, p, p, p, p, p]
    return lib


def launcher(lib, args):
    """The wrapper's launch (``fse_torch.decode_seq_streams``) on ``lib``,
    with the outputs and the scratch allocated once."""
    payload, rows, seq_off, al, tables = args
    B = rows.shape[0]
    total, widest, longest = torch.stack(
        [seq_off[-1], rows[:, 1].max(), (seq_off[1:] - seq_off[:-1]).max()]).tolist()
    dev = payload.device
    outs = [torch.empty(total, dtype=torch.int32, device=dev) for _ in range(3)]
    outs += [torch.empty(B, dtype=torch.int32, device=dev),
             torch.empty(B, dtype=torch.bool, device=dev)]
    rec = torch.empty((total, 2), dtype=torch.int32, device=dev)

    def run():
        rc = lib.zp_fse_decode(
            payload.data_ptr(), payload.numel(), rows.data_ptr(), seq_off.data_ptr(),
            al.data_ptr(), tables.data_ptr(), B, int(longest > 0),
            min(max(widest, 0), fse_torch.STAGE_CAP), rec.data_ptr(),
            *(t.data_ptr() for t in outs), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"zp_fse_decode: CUDA error {rc}")

    return run, outs, longest


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fse_profile: no CUDA GPU visible", file=sys.stderr)
        return 1
    sources = sys.argv[1:] or [str(_build.CSRC / "fse_decode.cu")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    _, comp = cs.write_zstd_entry(corpus, dev, extract)
    modules = {"huffman_decode": huffman_torch, "fse_decode": fse_torch,
               "rep_totals": fse_torch, "rep_apply": fse_torch, "lz4_replay": lz4_torch}
    with cs.recording_kernels(modules) as calls:
        if cs.zstd_python_route(extract, comp, len(corpus), dev) != corpus:
            raise AssertionError("zstd extract does not give the corpus back")
    args = calls["fse_decode"][0][0]
    want = fse_torch.decode_seq_streams_plain(*args)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, src in enumerate(sources):
            run, outs, longest = launcher(build(tmp, k, src), args)
            run()
            torch.cuda.synchronize()
            err = cs.max_abs_err(outs, want)
            print(f"{src}: {'equal' if err == 0 else 'DIFFERENT'} to plain (max_abs_err {err})")
            if err:
                return 1
            runs.append((src, run))
        for rnd, order in enumerate((runs, runs[::-1])):
            for src, run in order:
                ms = cs.cuda_ms(run, REPS)
                print(f"round {rnd + 1} {src}: {ms:.4f} ms a launch, "
                      f"{ms * 1e6 / longest:.1f} ns a step ({args[1].shape[0]} blocks, longest "
                      f"{longest} sequences)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
