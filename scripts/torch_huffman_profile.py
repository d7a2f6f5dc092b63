#!/usr/bin/env python3
"""Time the Huffman literal decoder at the zstd extract shape on a GPU, and
split the extract path's ``torch.huffman_decode`` phase into its steps.

    python3 scripts/torch_huffman_profile.py [SOURCE.cu [-DNAME[=VALUE] | -FLAG ...] ...]

Writes the 64 MiB corpus of ``chip_smoke.py`` as one zstd level-3 entry and
records the inputs of the Huffman decode of one read through the kernels'
Python wrappers (``chip_smoke.zstd_python_route``).  Each variant is a source (by default the
repo's ``zpack_tpu_torch/csrc/huffman_decode.cu``) with the ``-D`` and
other ``nvcc`` arguments that follow it, and has the C entry points of the
repo's.  Each variant is compiled alone, held against
``decode_streams_plain`` on the extract inputs and on every batch of
``kernels/huffman_cases.py`` (exact; a variant that differs, such as a
knock-out build, is timed all the same and marked), and its launch is timed
alone by CUDA
events (mean of 20; the outputs allocated and zeroed once), in the order
given and then in reverse, so that two variants are timed A, B, B, A in one
process.  The first variant is also built with ``-DZP_HUF_STAGE_ONLY`` (the
kernel stops after staging the stream and its table) to time the staging.
Prints the card's name and power limit first, the batch's shape and how
many of its CTAs are resident at once, then per variant and round the ms a
launch and the ns a symbol of the longest stream.  Exits 1 if the first
variant differs from the plain version.

Last, the Huffman decode of the Python walk's batch (``walk_zstd``,
where the native one is missing), 7 times, each step ended by a
synchronisation: ``build_decode_batch`` (the host loop over the streams and
the table packing), the pageable host-to-device copies of its arrays, the
launch (the wrapper, its output zeroed) and the read-back of ``final``;
and the whole decoder call without the inner synchronisations (the zstd
route itself stages its arrays in one pinned copy and reads ``final`` with
the rest of its record).  Prints each step's median and range in
ms.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch.kernels import (_build, fse_torch, huffman_cases,  # noqa: E402
                                     huffman_torch, lz4_torch)
from zpack_tpu_torch.parallel import extract  # noqa: E402

REPS = 20
SPLIT_REPS = 7


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
    return out or [(str(_build.CSRC / "huffman_decode.cu"), [])]


def build(tmp: str, k: int, src: str, defines: list[str]):
    so = os.path.join(tmp, f"huffman_decode_{k}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", so, src],
                   check=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(so)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zp_huffman_decode.restype = i
    lib.zp_huffman_decode.argtypes = [p, i64, p, i, p, i, p, i64, p, i, p]
    lib.zp_huffman_decode_occupancy.restype = i
    lib.zp_huffman_decode_occupancy.argtypes = [i, p]
    return lib


def launcher(lib, args, n_out: int, widest: int):
    """The wrapper's launch (``huffman_torch.decode_streams``) on ``lib``,
    with the outputs allocated and zeroed once."""
    payload, rows, tables = args
    S = rows.shape[0]
    out = torch.zeros(n_out, dtype=torch.uint8, device=payload.device)
    final = torch.zeros(S, dtype=torch.int32, device=payload.device)
    stage = huffman_torch.stage_size(widest)

    def run():
        rc = lib.zp_huffman_decode(
            payload.data_ptr(), payload.numel(), rows.data_ptr(), S, tables.data_ptr(),
            tables.shape[0], out.data_ptr(), n_out, final.data_ptr(), stage,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"zp_huffman_decode: CUDA error {rc}")

    return run, (out, final)


def check(lib, label: str, args, kwargs, want) -> bool:
    run, got = launcher(lib, args, kwargs["n_out"], kwargs["widest"])
    run()
    torch.cuda.synchronize()
    err = cs.max_abs_err(got, want)
    print(f"{label}: {'equal' if err == 0 else 'DIFFERENT'} to plain (max_abs_err {err})")
    return err == 0


def split_phase(comp: bytes, dev) -> None:
    """The ``torch.huffman_decode`` phase of ``decompress_zstd_device``, step
    by step."""
    w = extract.walk_zstd(comp)
    LB, stream_dst, raw_parts = extract._literal_layout(w)
    n_out = len(w.frames) * LB
    steps: dict[str, list[float]] = {}

    def lap(name: str, t0: float) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps.setdefault(name, []).append((t - t0) * 1e3)
        return t

    for _ in range(SPLIT_REPS):
        torch.cuda.synchronize()
        t = t0 = time.perf_counter()
        batch = huffman_torch.build_decode_batch(w.streams, w.tables, w.n_syms, stream_dst)
        t = lap("build_decode_batch (host)", t)
        args = [torch.from_numpy(batch[k]).to(dev) for k in huffman_torch.DECODE_ARGS]
        t = lap("h2d of payload, rows, tables (pageable)", t)
        lit, final = huffman_torch.decode_streams(*args, n_out=n_out, widest=batch["widest"])
        t = lap("launch (wrapper, output zeroed)", t)
        if (final.cpu().numpy() != 0).any():
            raise AssertionError("huffman stream not fully consumed")
        lap("read-back of final", t)
        lap("sum of the steps", t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lit, final = huffman_torch.TorchHuffmanDecoder(dev).decode_batch_device(
            w.streams, w.tables, w.n_syms, stream_dst, n_out=n_out)
        if (final != 0).any():
            raise AssertionError("huffman stream not fully consumed")
        lap("the decoder as the Python walk's batch runs it", t0)
    print(f"torch.huffman_decode split ({len(w.streams)} streams, {len(raw_parts)} raw runs, "
          f"{tensor_mb(batch)} MB to the device; {SPLIT_REPS} runs, median [min, max] ms):")
    for name, ts in steps.items():
        print(f"  {name}: {statistics.median(ts):.3f} [{min(ts):.3f}, {max(ts):.3f}]")


def tensor_mb(batch: dict) -> str:
    return f"{sum(batch[k].nbytes for k in huffman_torch.DECODE_ARGS) / 1e6:.3f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_huffman_profile: no CUDA GPU visible", file=sys.stderr)
        return 1
    runs_of = variants(sys.argv[1:])
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
    args, kwargs = calls["huffman_decode"][0]
    rows = args[1]
    S, longest = rows.shape[0], int(rows[:, 3].max())
    want = huffman_torch.decode_streams_plain(*args, **kwargs)
    cases = []
    for name, case in huffman_cases.cases().items():
        b = case.batch
        c_args = [torch.from_numpy(b[k]).to(dev) for k in huffman_torch.DECODE_ARGS]
        c_kw = {"n_out": b["n_out"], "widest": b["widest"]}
        cases.append((name, c_args, c_kw, huffman_torch.decode_streams_plain(*c_args, **c_kw)))
    runs, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (src, defines) in enumerate(runs_of):
            label = " ".join([src, *defines])
            lib = build(tmp, k, src, defines)
            if k == 0:
                blocks = ctypes.c_int(0)
                stage = huffman_torch.stage_size(kwargs["widest"])
                if lib.zp_huffman_decode_occupancy(stage, ctypes.byref(blocks)):
                    raise RuntimeError("zp_huffman_decode_occupancy failed")
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                print(f"huffman_decode (zstd extract): {S} streams, longest {longest} symbols, "
                      f"widest row {kwargs['widest']} bytes (stage cap "
                      f"{huffman_torch.STAGE_CAP}): {blocks.value} CTAs an SM x {sms} SMs, "
                      f"{'all' if blocks.value * sms >= S else 'not all'} {S} CTAs resident")
            exact = check(lib, f"{label} on the zstd extract inputs", args, kwargs, want)
            for name, c_args, c_kw, c_want in cases:
                exact &= check(lib, f"{label} on case {name!r}", c_args, c_kw, c_want)
            if not exact:
                failed.append(label)
                label += " (not exact)"
            runs.append((label, launcher(lib, args, kwargs["n_out"], kwargs["widest"])[0]))
        src, defines = runs_of[0]
        stage_only = build(tmp, len(runs_of), src, [*defines, "-DZP_HUF_STAGE_ONLY"])
        ms = cs.cuda_ms(launcher(stage_only, args, kwargs["n_out"], kwargs["widest"])[0], REPS)
        print(f"staging alone ({' '.join([src, *defines])} -DZP_HUF_STAGE_ONLY): {ms:.4f} ms "
              f"a launch")
        for rnd, order in enumerate((runs, runs[::-1])):
            for label, run in order:
                ms = cs.cuda_ms(run, REPS)
                print(f"round {rnd + 1} {label}: {ms:.4f} ms a launch, "
                      f"{ms * 1e6 / longest:.1f} ns a symbol of the longest stream")
    ms = cs.cuda_ms(lambda: huffman_torch.decode_streams(*args, **kwargs), REPS)
    print(f"through the wrapper (output zeroed each call): {ms:.4f} ms a call")
    split_phase(comp, dev)
    if failed:
        print(f"not exact: {failed}", file=sys.stderr)
    return 1 if runs and runs[0][0].endswith("(not exact)") else 0


if __name__ == "__main__":
    sys.exit(main())
