#!/usr/bin/env python3
"""Time the LZ4 block parse's walk at the main path's shape on a GPU.

    python3 scripts/torch_lz4_parse_profile.py [SOURCE.cu [-DNAME[=VALUE] | -FLAG ...] ...]

Writes the 64 MiB corpus of ``chip_smoke.py`` as one LZ4 level-1 frame with
the port's compressor (the GPU route) and takes its compressed blocks, the
rows of the extract's parse.  Each variant is a source (by default the
repo's ``zpack_tpu_torch/csrc/lz4_parse.cu``) with the ``-D`` and other
``nvcc`` arguments that follow it, and has the C entry points of the
repo's.  Each variant is compiled alone and run on the wrapper's tensors
(``lz4_torch._parse_walk``: the same plan, rows and scratch); its ``info``
and records are held against the repo's kernel (exact; a variant that
differs is timed all the same and marked), and its launch is timed by CUDA
events (mean of 20): both steps, the chain step alone and the values step
alone (each with its staging), and the staging alone, in the order given
and then in reverse, so that two variants are timed A, B, B, A in one
process.  Then the first variant's chain is timed on single rows (common
tokens only, a match-length byte on every token, the main path's longest
chain, its row with the most extensions) and in every grouping of rows a
CTA (``PARSE_GROUPS``), with its waves and the walkers resident at once;
last, the repo's wrapper (``parse_batch``) is split into its steps.
Prints the card's name and power limit first, then per variant and round
the ms of each launch and the ns a step of the longest block's chain.
Exits 1 if the first variant differs from the repo's kernel.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch.kernels import _build, lz4_parse_cases, lz4_torch  # noqa: E402
from zpack_tpu_torch.parallel import extract  # noqa: E402
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor  # noqa: E402

REPS = 20


def variants(argv: list[str]) -> list[tuple[str, list[str]]]:
    """``SOURCE [-FLAG...] SOURCE [-FLAG...]`` into (source, flags) pairs."""
    out: list[tuple[str, list[str]]] = []
    for a in argv:
        if a.startswith("-"):
            if not out:
                raise SystemExit(f"{a} comes before any source")
            out[-1][1].append(a)
        else:
            out.append((a, []))
    return out or [(str(_build.CSRC / "lz4_parse.cu"), [])]


def build(tmp: str, k: int, src: str, flags: list[str]):
    so = os.path.join(tmp, f"lz4_parse_{k}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", so, src],
                   check=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zp_lz4_parse_walk.restype = i
    lib.zp_lz4_parse_walk.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p]
    return lib


def launcher(lib, payload, w):
    """The wrapper's walk launch (``lz4_torch._walk_launch``) on ``lib``."""
    plan = w["plan"]

    def run(steps: int):
        rc = lib.zp_lz4_parse_walk(
            payload.data_ptr(), w["rows"].data_ptr(), w["rec_off"].data_ptr(),
            w["slots"].data_ptr(), plan["ctas"], plan["group"], plan["smem"], steps,
            w["tpos"].data_ptr(), w["chain"].data_ptr(), w["rec"].data_ptr(),
            w["info"].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"zp_lz4_parse_walk: CUDA error {rc}")

    return run


def records(w) -> list[np.ndarray]:
    """Each row's records up to its n_seq, and the info."""
    info, rec, off = (w[k].cpu().numpy() for k in ("info", "rec", "rec_off"))
    return [info] + [rec[o:o + n] for o, n in zip(off, info[:, 0])]


def timed(run, steps: int) -> float:
    return cs.cuda_ms(lambda: run(steps), REPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lz4_parse_profile: no CUDA GPU visible", file=sys.stderr)
        return 1
    runs_of = variants(sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    _, blocks, bounds, _ = extract.walk_lz4f(DeviceCompressor(dev).compress(corpus))
    flat, offsets = lz4_torch.pack_blocks(blocks)
    payload = flat.to(dev)
    w = lz4_torch._parse_walk(payload, offsets)
    want = records(w)
    longest = int(want[0][:, 0].max())
    plan = w["plan"]
    print(f"lz4_parse walk (main-path blocks): {len(blocks)} rows, {len(flat)} bytes, longest "
          f"chain {longest} sequences; {plan['ctas']} CTAs of {plan['group']} rows, a "
          f"{plan['smem']}-byte stage, {plan['per_sm']} an SM: {plan['resident']} walkers "
          f"resident at once ({plan['waves']} wave(s))")
    runs, failed, libs = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (src, flags) in enumerate(runs_of):
            label = " ".join([src, *flags])
            libs.append(build(tmp, k, src, flags))
            run = launcher(libs[-1], payload, w)
            for t in ("tpos", "chain", "rec", "info"):
                w[t].fill_(-1)
            run(3)
            torch.cuda.synchronize()
            same = all(np.array_equal(g, h) for g, h in zip(records(w), want))
            print(f"{label}: {'equal' if same else 'DIFFERENT'} to the repo's kernel")
            if not same:
                failed.append(k)
            runs.append((label, run))
        for rnd, order in enumerate((runs, runs[::-1])):
            for label, run in order:
                both, chain, values = timed(run, 3), timed(run, 1), timed(run, 2)
                print(f"round {rnd + 1} {label}: both steps {both:.3f} ms, the chain alone "
                      f"{chain:.3f} ({chain * 1e6 / longest:.1f} ns a step), the values alone "
                      f"{values:.3f}, the staging alone {timed(run, 0):.3f}")
        slow = [int(((r[:, 0] >= 15) | (r[:, 2] >= 19)).sum()) for r in want[1:]]
        singles = {
            "common tokens only (1 literal, offset 1, match 4)":
                lz4_parse_cases.encode([(b"a", 1, 4)] * 16000),
            "match nibble 15 on every token (one extension byte)":
                lz4_parse_cases.encode([(b"a", 1, 24)] * 12000),
            "the main path's longest chain": blocks[int(want[0][:, 0].argmax())],
            "the main path's row with the most extensions": blocks[int(np.argmax(slow))],
        }
        for name, blk in singles.items():
            f1, o1 = lz4_torch.pack_blocks([blk])
            p1 = f1.to(dev)
            w1 = lz4_torch._parse_walk(p1, o1)
            r1 = launcher(libs[0], p1, w1)
            n1 = int(w1["info"][0, 0])
            chain = timed(r1, 1)
            print(f"{runs[0][0]} on one row, {name} ({len(blk)} bytes, {n1} sequences): the "
                  f"chain alone {chain:.3f} ms ({chain * 1e6 / max(n1, 1):.1f} ns a step)")
        groups = lz4_torch.PARSE_GROUPS
        for g in groups:
            lz4_torch.PARSE_GROUPS = (g,)
            try:
                wg = lz4_torch._parse_walk(payload, offsets)
            finally:
                lz4_torch.PARSE_GROUPS = groups
            p = wg["plan"]
            rg = launcher(libs[0], payload, wg)
            both, chain = timed(rg, 3), timed(rg, 1)
            print(f"{runs[0][0]} at {g} rows a CTA ({p['ctas']} CTAs, {p['smem']}-byte stage, "
                  f"{p['per_sm']} an SM, {p['waves']} wave(s), {p['resident']} walkers "
                  f"resident): both steps {both:.3f} ms, the chain alone {chain:.3f} "
                  f"({chain * 1e6 / longest:.1f} ns a step)")
    split_wrapper(payload, offsets, bounds)
    return 1 if 0 in failed else 0


def split_wrapper(payload, offsets, bounds) -> None:
    """``lz4_torch.parse_batch`` on the main path's blocks step by step, each
    step ended by a synchronisation, 7 times: the host plan, the walk's
    upload, allocations and launch, the read-back of ``info`` and the
    checks, the layout; and the wrapper whole.  Prints each step's median
    and range in ms."""
    dev = payload.device
    steps: dict[str, list[float]] = {}

    def lap(name: str, t0: float) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps.setdefault(name, []).append((t - t0) * 1e3)
        return t

    lens = np.diff(offsets)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for _ in range(7):
        torch.cuda.synchronize()
        t = t0 = time.perf_counter()
        lz4_torch.parse_plan(lens, lambda smem: lz4_torch.walk_ctas_per_sm(smem, dev), sms)
        t = lap("parse_plan (host)", t)
        w = lz4_torch._parse_walk(payload, offsets)
        t = lap("_parse_walk (the plan again, upload, allocations, both steps)", t)
        n_seq, lit_total, out_len, err = w["info"].cpu().numpy().T
        if err.any() or (out_len > np.asarray(bounds, np.int64)).any():
            raise AssertionError("the main path's blocks do not parse")
        bp, S, L, _ = lz4_torch._batch_shape(n_seq, lit_total, out_len)
        t = lap("read-back of info, the checks, the shape", t)
        lz4_torch._parse_layout(payload, w, bp, S, L)
        t = lap("_parse_layout (allocations, launch)", t)
        lz4_torch.parse_batch(payload, offsets, bounds)
        lap("parse_batch whole", t)
    print("lz4_parse wrapper split (main-path blocks; 7 runs, median [min, max] ms):")
    for name, ts in steps.items():
        print(f"  {name}: {statistics.median(ts):.3f} [{min(ts):.3f}, {max(ts):.3f}]")


if __name__ == "__main__":
    sys.exit(main())
