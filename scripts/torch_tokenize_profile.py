#!/usr/bin/env python3
"""Time the LZ4 match finder's steps one by one on a GPU.

    python3 scripts/torch_tokenize_profile.py [--steps=N] [-DNAME[=VALUE] ...]

Compiles ``zpack_tpu_torch/csrc/lz4_tokenize.cu`` alone, once per step, with
``-DZP_LZ4_STAGES=n`` (the kernel returns after step n: 1 the window's bytes
into shared memory, 2 the first radix pass, 3 the second, 4 the ``prev``
table, 5 the chain walk, the stores and the estimate), and times each build
by CUDA events (mean of 20 launches) on the shapes of ``chip_smoke.py``'s
rows: "pair" on 256 blocks of 64 KiB, "u16" on the corpus in 8 KiB blocks,
"hash" and "scatter" on the corpus in 64 KiB blocks, and windows of 10,240
("pair") and 6,144 ("u16") bytes with a 2 KiB dictionary.  A step's time is
the difference of two builds.  The full build is first held against
``tokenize_plain`` on every shape (exact).  Further ``-D`` arguments go to
every compile, to time a variant of the source; ``--steps=N`` builds and
times the first N steps only, without the comparison (for a variant whose
later steps are not meant to run).  Prints the card's name and power limit
first.
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
from zpack_tpu_torch.kernels import _build, lz4_torch  # noqa: E402

STAGES = ("bytes to shared memory", "radix pass, low digit", "radix pass, high digit",
          "prev table", "chain walk, stores, estimate")
REPS = 20


def build(tmp: str, stage: int, defines: list[str]):
    so = os.path.join(tmp, f"tokenize_{stage}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DZP_LZ4_STAGES={stage}", *defines,
                    "-shared", "-o", so, str(_build.CSRC / "lz4_tokenize.cu")],
                   check=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zp_lz4_tokenize.restype = i
    lib.zp_lz4_tokenize.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p]
    return lib


def launcher(lib, blocks: torch.Tensor, mode: str, capj: int, dict_pad: int):
    """The wrapper's launch (``lz4_torch.tokenize_est``) on ``lib``, with the
    outputs and the scratch allocated once."""
    nb, W = blocks.shape
    cols = W if mode == "hash" else W - dict_pad
    outs = [torch.zeros((nb, cols), dtype=t, device=blocks.device)
            for t in lz4_torch.WIRE_DTYPES[mode]]
    est = torch.zeros(1, dtype=torch.int64, device=blocks.device)
    order = None
    if W > lz4_torch.TOKENIZE_SMALL_WINDOW and mode != "hash":
        order = torch.empty((nb, W), dtype=torch.int16, device=blocks.device)

    def run():
        est.zero_()
        rc = lib.zp_lz4_tokenize(
            blocks.data_ptr(), nb, W, dict_pad, 2, capj, lz4_torch.MODES.index(mode),
            None if order is None else order.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None, est.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"zp_lz4_tokenize: CUDA error {rc}")

    return run, outs, est


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 1
    defines = [a for a in sys.argv[1:] if a.startswith("-D")]
    steps = [int(a.split("=")[1]) for a in sys.argv[1:] if a.startswith("--steps=")]
    n_steps = steps[0] if steps else len(STAGES)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    cut = cs.zstd_cut(corpus, cs.ZSTD_BYTES)
    head = torch.frombuffer(bytearray(cut[:2048]), dtype=torch.uint8).to(dev)
    blocks64k = cs.corpus_blocks(corpus, cs.BLOCK, dev)

    def windows(B: int) -> torch.Tensor:
        data = cs.corpus_blocks(cut, B, dev)
        return torch.cat([head.expand(len(data), len(head)), data], dim=1)

    shapes = [("pair", 8, cs.tokenizer_blocks(corpus, dev), 0),
              ("u16", 8, blocks64k.view(-1, 8192), 0),
              ("hash", 16, blocks64k, 0),
              ("scatter", 16, blocks64k, 0),
              ("pair", 8, windows(8192), 2048),
              ("u16", 8, windows(4096), 2048)]
    print(f"defines: {defines or 'none'}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = [build(tmp, n, defines) for n in range(1, n_steps + 1)]
        for mode, capj, blocks, dict_pad in shapes:
            if n_steps == len(STAGES):
                run, outs, est = launcher(libs[-1], blocks, mode, capj, dict_pad)
                run()
                want = lz4_torch.tokenize_plain(blocks, 2, capj, mode, dict_pad)
                torch.cuda.synchronize()
                if cs.max_abs_err(outs, want) or int(est[0] - lz4_torch.est_plain(want, mode)[0]):
                    raise AssertionError(
                        f"kernel != plain in mode {mode} on {tuple(blocks.shape)}")
                del want
            times = [cs.cuda_ms(launcher(lib, blocks, mode, capj, dict_pad)[0], REPS)
                     for lib in libs]
            steps = [t - u for t, u in zip(times, [0.0] + times[:-1])]
            print(f"{mode} {blocks.shape[0]} x {blocks.shape[1]} (dictionary {dict_pad}, "
                  f"cap {capj}): {'equal to plain, ' if n_steps == len(STAGES) else ''}"
                  f"{times[-1]:.3f} ms for {n_steps} steps")
            for name, t, total in zip(STAGES, steps, times):
                print(f"  {t:8.3f} ms  {name}  (build returns at {total:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
