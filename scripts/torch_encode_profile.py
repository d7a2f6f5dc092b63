#!/usr/bin/env python3
"""Time the many-stream XXH3 kernel on its sets, the FSE sequence encode's
two steps and the Huffman literal encode on the zstd compress path's
batches, on a GPU.

    python3 scripts/torch_encode_profile.py [--xxh3 SOURCE.cu [-DNAME[=VALUE] ...] ...]
                                            [--fse SOURCE.cu [-DNAME[=VALUE] ...] ...]
                                            [--huffman SOURCE.cu [-DNAME[=VALUE] ...] ...]

Each variant is a source (by default the repo's
``zpack_tpu_torch/csrc/xxh3_batch.cu`` and ``fse_encode.cu``) with the
``nvcc`` arguments that follow it, compiled alone, with the C entry points
of the repo's.  XXH3: each variant runs on the sets of ``chip_smoke.py``
(128 x 512 KiB, the 10,011 files, 8 x 8 MiB), held against the repo's
kernel (exact), and is timed by CUDA events (mean of 20 launches).  FSE:
one ``compress_zstd`` of the 16 MiB cut of ``chip_smoke.py`` records the
batches the main path encodes; each variant is held against the repo's
kernel on them (exact), and its launch over all of them is timed whole, the
state walk alone and the packing alone (mean of 20).  Huffman: the same
run's literal batches; each variant is held against the repo's kernel
(each stream's words exact) and its launch alone is timed on the device
(``chip_smoke.queued_ms``: mean of 50, a sleep kernel queued ahead so that
the host's launch rate does not count; the outputs made once), beside an
empty kernel on the same grid.  Then the encoder's host steps on the
recorded calls (the repo's module).  Variants run in the order given and
then in reverse, so that two are timed A, B, B, A in one process.  Prints
the card's name and power limit first and beside every number.  Exits 1 if
a variant differs from the repo's kernel.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zpack_tpu_torch.kernels import _build, fse_torch, huffman_torch, xxh3_torch  # noqa: E402
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor  # noqa: E402

REPS = 20


def variants(argv: list[str]) -> dict:
    """``--xxh3 SOURCE [-FLAG...] ... --fse SOURCE [-FLAG...] ... --huffman
    SOURCE [-FLAG...] ...`` into {"xxh3": [(source, flags)], "fse": [...],
    "huffman": [...]}: the kinds named, or with none named, each kind with
    the repo's source."""
    out: dict = {"xxh3": [], "fse": [], "huffman": []}
    kind = None
    for a in argv:
        if a in ("--xxh3", "--fse", "--huffman"):
            kind = a[2:]
        elif kind is None:
            raise SystemExit(f"{a} comes before --xxh3, --fse or --huffman")
        elif a.startswith("-"):
            if not out[kind]:
                raise SystemExit(f"{a} comes before any source")
            out[kind][-1][1].append(a)
        else:
            out[kind].append((a, []))
    if any(out.values()):  # only the kinds named
        return out
    defaults = {"xxh3": "xxh3_batch.cu", "fse": "fse_encode.cu", "huffman": "huffman_encode.cu"}
    return {k: [(str(_build.CSRC / defaults[k]), [])] for k in out}


def build(tmp: str, name: str, src: str, flags: list[str]):
    so = os.path.join(tmp, f"{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", *flags, "-shared",
                    "-o", so, src], check=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "zp_xxh3_batch"):
        lib.zp_xxh3_batch.restype = i
        lib.zp_xxh3_batch.argtypes = [p, ctypes.c_longlong, p, i, p, p, p, p]
    if hasattr(lib, "zp_fse_encode"):
        lib.zp_fse_encode.restype = i
        lib.zp_fse_encode.argtypes = [p, p, p, p, p, i, i, i, p, p, p, p]
    if hasattr(lib, "zp_huffman_encode"):
        lib.zp_huffman_encode.restype = i
        lib.zp_huffman_encode.argtypes = [p, p, p, i, p, p, p]
        lib.zp_launch_floor.restype = i
        lib.zp_launch_floor.argtypes = [i, p]
    return lib


def huffman_runs(lib, batches: list, dev) -> dict:
    """The launch over all batches, an empty kernel on the same grid, and a
    check against the repo kernel's outputs."""
    stream = torch.cuda.current_stream().cuda_stream
    todo, want = [], []
    for b in batches:
        args = [torch.from_numpy(b[k]).to(dev) for k in huffman_torch.BATCH_ARGS]
        want.append(huffman_torch.encode_streams(*args, n_words=b["n_words"]))
        todo.append((args, torch.empty(b["n_words"], dtype=torch.int32, device=dev),
                     torch.empty(len(b["rows"]), dtype=torch.int32, device=dev)))

    def launch():
        for (syms, rows, tables), words, total in todo:
            rc = lib.zp_huffman_encode(syms.data_ptr(), rows.data_ptr(), tables.data_ptr(),
                                       rows.shape[0], words.data_ptr(), total.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"zp_huffman_encode: CUDA error {rc}")

    def floor():
        for (_, rows, _), _, _ in todo:
            if lib.zp_launch_floor(rows.shape[0], stream):
                raise RuntimeError("zp_launch_floor failed")

    def same():
        return all(torch.equal(w, ww) and torch.equal(t, wt)
                   for (_, w, t), (ww, wt) in zip(todo, want))

    return {"launch": launch, "floor": floor, "same": same}


def xxh3_runs(lib, sets: dict, dev) -> list:
    """Per set: (name, MB, run, outputs, the repo kernel's outputs)."""
    secret = xxh3_torch.secret_tensor(dev)
    out = []
    for name, streams in sets.items():
        n = len(streams)
        flat, offsets = xxh3_torch.split_packed(xxh3_torch.pack(streams).to(dev), n)
        acc = torch.empty((n, 8), dtype=torch.int64, device=dev)
        hashes = torch.empty(n, dtype=torch.int64, device=dev)

        def run(flat=flat, offsets=offsets, n=n, acc=acc, hashes=hashes):
            rc = lib.zp_xxh3_batch(flat.data_ptr(), flat.numel(), offsets.data_ptr(), n,
                                   secret.data_ptr(), acc.data_ptr(), hashes.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"zp_xxh3_batch: CUDA error {rc}")

        want = xxh3_torch.accumulate_batch(flat, offsets, secret)
        out.append((name, sum(map(len, streams)) / 1e6, run, (acc, hashes), want))
    return out


def fse_runs(lib, batches: list, dev):
    """The launch over all batches for ``steps``, its outputs, and the repo
    kernel's outputs."""
    tensors, outs, want = [], [], []
    for b in batches:
        args = [torch.from_numpy(b[k]).to(dev) for k in fse_torch.BATCH_ARGS]
        tensors.append(args)
        outs.append((torch.zeros(b["n_words"], dtype=torch.int32, device=dev),
                     torch.empty(len(b["seq_off"]) - 1, dtype=torch.int32, device=dev)))
        want.append(fse_torch.encode_seq_streams(*args, n_words=b["n_words"]))

    def run(steps: int):
        for (fields, seq_off, tables, al, word_off), (words, total) in zip(tensors, outs):
            n = fields.shape[0]
            stage = fse_torch.encode_stage(n)
            scratch = torch.empty(-(-10 * n // 4) if n > stage else 1, dtype=torch.int32,
                                  device=dev)
            rc = lib.zp_fse_encode(fields.data_ptr(), seq_off.data_ptr(), tables.data_ptr(),
                                   al.data_ptr(), word_off.data_ptr(), seq_off.shape[0] - 1,
                                   stage, steps, scratch.data_ptr(), words.data_ptr(),
                                   total.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"zp_fse_encode: CUDA error {rc}")

    return run, outs, want


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_encode_profile: no CUDA GPU visible", file=sys.stderr)
        return 1
    todo = variants(sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    sets = cs.xxh3_sets(corpus)
    cut = cs.zstd_cut(corpus, cs.ZSTD_BYTES)
    rec = cs.record_zstd_batches(cut, dev, DeviceCompressor, huffman_torch, fse_torch)
    batches = rec["fse"]
    longest = max(int((b["seq_off"][1:] - b["seq_off"][:-1]).max()) for b in batches)
    with tempfile.TemporaryDirectory() as tmp:
        xr, fr = [], []
        for k, (src, flags) in enumerate(todo["xxh3"]):
            label = " ".join([src, *flags])
            runs = xxh3_runs(build(tmp, f"xxh3_{k}", src, flags), sets, dev)
            for name, _, run, got, want in runs:
                run()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    print(f"{label} on {name}: DIFFERENT from the repo's kernel")
                    return 1
            print(f"{label}: equal to the repo's kernel on {len(runs)} sets")
            xr.append((label, runs))
        for k, (src, flags) in enumerate(todo["fse"]):
            label = " ".join([src, *flags])
            run, outs, want = fse_runs(build(tmp, f"fse_{k}", src, flags), batches, dev)
            run(3)
            torch.cuda.synchronize()
            if not all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                       for g, w in zip(outs, want)):
                print(f"{label}: DIFFERENT from the repo's kernel")
                return 1
            print(f"{label}: equal to the repo's kernel on {len(batches)} batches")
            fr.append((label, run))
        hr = []
        for k, (src, flags) in enumerate(todo["huffman"]):
            label = " ".join([src, *flags])
            run = huffman_runs(build(tmp, f"huffman_{k}", src, flags), rec["huffman"], dev)
            run["launch"]()
            torch.cuda.synchronize()
            if not run["same"]():
                print(f"{label}: DIFFERENT from the repo's kernel")
                return 1
            print(f"{label}: equal to the repo's kernel on {len(rec['huffman'])} batches")
            hr.append((label, run))
        for rnd, order in enumerate((xr, xr[::-1])):
            for label, runs in order:
                for name, mb, run, _, _ in runs:
                    ms = cs.cuda_ms(run, REPS)
                    print(f"round {rnd + 1} xxh3_batch {label} on {name}: {ms:.4f} ms "
                          f"({mb / ms * 1e-3:.3f} TB/s) [{card}]")
        for rnd, order in enumerate((fr, fr[::-1])):
            for label, run in order:
                launch, chain, fields = (cs.cuda_ms(lambda: run(s), REPS) for s in (3, 1, 2))
                print(f"round {rnd + 1} fse_encode {label} ({sum(len(b['seq_off']) - 1 for b in batches)} "
                      f"blocks, longest {longest}): launch {launch:.4f} ms, state walk alone "
                      f"{chain:.4f} ms ({chain * 1e6 / longest:.1f} ns a step), packing alone "
                      f"{fields:.4f} ms [{card}]")
        for rnd, order in enumerate((hr, hr[::-1])):
            for label, run in order:
                launch, floor = cs.queued_ms(run["launch"], 50), cs.queued_ms(run["floor"], 50)
                print(f"round {rnd + 1} huffman_encode {label}: launch {launch:.4f} ms, empty "
                      f"kernel on the same grid {floor:.4f} ms [{card}]")
    if todo["huffman"]:
        for rnd in (1, 2):
            steps = cs.huffman_steps(rec["huffman_calls"], dev, huffman_torch)
            print(f"round {rnd} huffman_encode host steps of the repo's encoder (ms, median of "
                  f"7): {json.dumps(steps)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
