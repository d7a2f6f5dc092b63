#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one GPU, in one run.

    python3 scripts/torch_ab.py [--extract | --lz4-extract | --lz4-parse | --xxh3-batch |
                                 --fse-encode | --huffman-encode] PARENT_DIR CHANGE_DIR

Runs parent, change, change, parent, each in a process of its own with its
own build of the kernels: two checkouts are compared only inside one run on
one card.  Each side drives, through its own ``chip_smoke.py``'s phases,

* the LZ4 match finder against its plain version in every wire format, at
  the shapes of the ``kernels`` line (kernel ms, plain ms),
* the sequence replay against its plain version on the main path's LZ4
  rows (kernel ms, plain ms),
* the LZ4 archive round trip of the 64 MiB corpus, twice,
* the zstd extract kernels against their plain versions on the inputs of
  one read (kernel ms, plain ms),
* ``Reader.read_file`` of the corpus as one zstd entry, four times, with
  the phases of the last two.

With ``--extract`` each side runs the last two only (the zstd extract
kernels and reads), for a change to the decoders.  With ``--lz4-extract``
each side runs the LZ4 archive round trip only (``phase_main_path``, two
runs of create and extract), for a change to the LZ4 extract path.  With
``--lz4-parse`` each side runs its LZ4 block parse phase (the kernel
against ``build_batch``, the wrapper, the walk and the layout timed), then
the round trip, for a change to the parse.  With ``--xxh3-batch`` each
side runs its many-stream XXH3 phase on 128 x 512 KiB, the 10,011 files
and 8 x 8 MiB (kernel ms, plain ms, the entry point end to end), then the
batches of ``kernels/xxh3_cases.py`` where its checkout has them.  With
``--fse-encode`` each side records the zstd compress path's FSE batches on
the 16 MiB cut, runs its FSE encode phase on them (kernel ms, and where its
checkout has them the state walk and the packing apart), the batches of
``kernels/fse_encode_cases.py`` where it has them, then the zstd compress
phase (end to end, device and host entropy).  With ``--huffman-encode``
each side records the zstd compress path's Huffman batches on the 16 MiB
cut, times its ``encode_streams`` through the wrapper on them (mean of 10
passes) and the device work that the wrapper queues (the kernel, and any
fill of the plane; 50 passes queued behind a sleep kernel, so that the
host's rate of launching does not count), runs the batches of ``kernels/huffman_encode_cases.py`` and times
its encoder's host steps (``chip_smoke.huffman_steps``) where its checkout
has them, then the zstd compress phase.

Prints the card's name and power limit first, then each side's lines as
the phases print them.  Needs a CUDA GPU; exits non-zero if a side fails.
"""

from __future__ import annotations

import subprocess
import sys

SIDE = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from zpack_tpu_torch.codecs.lz4 import block as lz4block
from zpack_tpu_torch.kernels import fse_torch, huffman_torch, lz4_torch
from zpack_tpu_torch.parallel import extract
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

dev = torch.device("cuda")
corpus = cs.build_corpus(cs.CORPUS_BYTES)
if MODE == "--lz4-extract":
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import _build
    _build.lib()  # both builds before the first round trip
    native.get_lib()
    cs.phase_main_path(corpus, dev, lz4_torch)
    sys.exit(0)
if MODE == "--lz4-parse":
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import _build
    _build.lib()
    native.get_lib()
    cs.phase_lz4_parse(corpus, dev, lz4_torch, extract, DeviceCompressor)
    cs.phase_main_path(corpus, dev, lz4_torch)
    sys.exit(0)
if MODE == "--xxh3-batch":
    from zpack_tpu_torch.codecs import xxh3 as H
    from zpack_tpu_torch.kernels import _build, xxh3_torch
    _build.lib()
    sets = cs.xxh3_sets(corpus)
    eighth = len(corpus) // 8
    sets.setdefault("8 x 8 MiB", [corpus[i * eighth:(i + 1) * eighth] for i in range(8)])
    cs.phase_xxh3_batch(sets, dev, xxh3_torch, H)
    if hasattr(cs, "phase_xxh3_cases"):
        cs.phase_xxh3_cases(dev, xxh3_torch, H)
    sys.exit(0)
if MODE == "--fse-encode":
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import _build
    _build.lib()
    native.get_lib()
    cut = cs.zstd_cut(corpus, cs.ZSTD_BYTES)
    rec = cs.record_zstd_batches(cut, dev, DeviceCompressor, huffman_torch, fse_torch)
    cs.phase_fse(rec["fse"], dev, fse_torch)
    if hasattr(cs, "phase_fse_encode_cases"):
        cs.phase_fse_encode_cases(dev, fse_torch)
    cs.phase_zstd(cut, corpus, rec["frame"], dev, DeviceCompressor, huffman_torch, fse_torch)
    sys.exit(0)
if MODE == "--huffman-encode":
    import json
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import _build
    _build.lib()
    native.get_lib()
    cut = cs.zstd_cut(corpus, cs.ZSTD_BYTES)
    rec = cs.record_zstd_batches(cut, dev, DeviceCompressor, huffman_torch, fse_torch)
    runs = [([torch.from_numpy(b[k]).to(dev) for k in huffman_torch.BATCH_ARGS], b["n_words"])
            for b in rec["huffman"]]

    def wrapper():
        for t, n in runs:
            huffman_torch.encode_streams(*t, n_words=n)

    ms = cs.cuda_ms(wrapper, 10)
    wrapper()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50 * 200_000)  # holds the stream while the host queues 50 passes
    start.record()
    for _ in range(50):
        wrapper()
    end.record()
    end.synchronize()
    print(f"huffman_encode: through the wrapper {ms:.4f} ms (mean of 10 passes), its device "
          f"work {start.elapsed_time(end) / 50:.4f} ms (mean of 50 queued passes)")
    if hasattr(cs, "phase_huffman_encode_cases"):
        cs.phase_huffman_encode_cases(dev, huffman_torch)
    if hasattr(cs, "huffman_steps"):
        for _ in range(2):
            steps = cs.huffman_steps(rec["huffman_calls"], dev, huffman_torch)
            print("huffman_encode host steps (ms, median of 7): " + json.dumps(steps))
    cs.phase_zstd(cut, corpus, rec["frame"], dev, DeviceCompressor, huffman_torch, fse_torch)
    sys.exit(0)
if MODE != "--extract":
    cs.phase_tokenize(corpus, dev, lz4_torch)
    cut = cs.zstd_cut(corpus, cs.ZSTD_BYTES)
    cs.phase_epilogues(corpus, cut, cs.train_blob(cut), dev, lz4_torch)
    cs.phase_replay(corpus, dev, lz4_torch, extract, DeviceCompressor, lz4block)
    cs.phase_main_path(corpus, dev, lz4_torch)
modules = {"huffman_decode": huffman_torch, "fse_decode": fse_torch, "rep_totals": fse_torch,
           "rep_apply": fse_torch, "lz4_replay": lz4_torch}
zbuf, zcomp = cs.write_zstd_entry(corpus, dev, extract)
cs.phase_zstd_extract_kernels(zcomp, corpus, dev, extract, modules)
cs.phase_zstd_extract_main(zbuf, zcomp, corpus, dev, modules)
cs.phase_zstd_extract_main(zbuf, zcomp, corpus, dev, modules)
'''

KEEP = ("tokenize (", "tokenize mode=", "lz4_tokenize", "lz4_est", "replay (", "main path rep",
        "main path phases", "main path launches", "lz4_parse",
        "zstd extract main path rep", "zstd extract main path phases",
        "fse_decode (zstd extract)", "huffman_decode (zstd extract)", "xxh3_batch", "xxh3 case",
        "fse_encode", "zstd main path", "zstd host-entropy", "zstd first run", "huffman_encode")


def main() -> int:
    args = sys.argv[1:]
    modes = ("--extract", "--lz4-extract", "--lz4-parse", "--xxh3-batch", "--fse-encode",
             "--huffman-encode")
    mode = args[0] if args[:1] and args[0] in modes else None
    if mode:
        args = args[1:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = args
    side = f"MODE = {mode!r}\n" + SIDE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    for name, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", side], cwd=tree, capture_output=True,
                             text=True, timeout=1200)
        print(f"== {name} ({tree}) on {card}")
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-2000:], file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith(KEEP):
                print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
