#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``zpack_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the toolchain, and
   builds the hand-written kernels from ``zpack_tpu_torch/csrc``;
2. holds the LZ4 match finder kernel against its plain PyTorch version on
   256 blocks of 64 KiB, at depth 2 and 8 and match caps 8 and 16, and on
   the adversarial windows of ``kernels/tokenize_cases.py`` in every wire
   format each admits (one hash bucket as long as the window, buckets across
   every warp's stretch, widths that are no power of two, dictionary
   windows, the end-of-window rules, chains longer than the depth; exact);
   then the block serializer on the tokenizer's tables of the main path's
   step and on every case of ``kernels/serialize_cases.py`` in both wire
   formats, against the native serializer and the plain version (exact),
   the kernel timed by CUDA events; and its HC parse (LZ4's high-compression
   levels) on that step, tokenized at an HC level's comparison at depth 8
   and at the cap, and on every case and HC case, against the native HC
   serializer and the plain version (exact), the match finder and the
   serializer timed at each depth;
3. holds the sequence replay kernel against its plain version on the
   replay batch of the main path's frames, on RLE-heavy blocks and on the
   adversarial batches of ``kernels/replay_cases.py`` (copy chains, sources
   at chunk edges, literal-only segments, every row shape; exact, and the
   kernel's error word must stay clear: the wrapper raises on it); then the
   block parse that builds that batch on the card against ``build_batch``
   on the main path's blocks and on the batches of
   ``kernels/lz4_parse_cases.py`` (length edges, the count bound, a row
   above the stage, every error in the host parse's order, offset errors
   before later chain errors, many tiny rows beside rows at and above the
   stage; exact), its walk's chain and values steps timed apart, and the
   walkers resident at once printed beside the blocks;
4. XXH3: holds the many-stream kernel against its plain version and the
   native host hash on 128 streams of 512 KiB, on 10,011 streams of
   241..65536 bytes and on 8 streams of 8 MiB (printing the grid it
   launches, a CTA a row), and on the batches of ``kernels/xxh3_cases.py``
   (edge lengths, chunk edges, overlapping rows in place, every rejected
   row beside a valid one, which must give zeros, 1,000 short rows beside
   one of 1 MiB), and the single-stream kernel on the 64 MiB corpus and
   short edge lengths (exact); then drives the XXH3 entry points over the
   entries of a 10,011-file stored archive (each hash must equal the
   entry's CDR hash) and over the corpus, and both kernels must have been
   launched by that run;
5. drives the LZ4 main path: the port's Writer and Reader with nothing
   installed (their default device is the GPU), over a deterministic 64 MiB
   corpus; the bytes
   must round-trip, the host decoder must read the port's frames, and the
   LZ4 match finder, serializer, parse and replay must have been launched by that run;
6. zstd compress: a first ``DeviceCompressor.compress_zstd`` run over a
   16 MiB cut of the corpus records the Huffman and FSE batches it builds;
   the Huffman literal-stream kernel and the FSE sequence-stream kernel are
   held against their plain versions on those batches (exact); the Huffman
   encode timed through its wrapper, its launch alone and an empty kernel on
   its grid (the launch floor), the encoder's host steps split and the
   streams' lengths printed, and the kernel held
   on the batches of ``kernels/huffman_encode_cases.py`` (one-symbol
   streams, codes of 11 bits and of 1 bit only, bits ending on a word and
   past it, lengths at group and tile edges, a stream above 64 KiB, uneven
   4-stream blocks, tiny streams beside a long one; exact); the FSE
   encode's state walk and packing timed apart, and on the batches of
   ``kernels/fse_encode_cases.py`` (every table mode, one and two
   sequences, offset code 31, 16-bit length extras, a block above the
   stage cap, 300 tiny blocks beside a long one, tile edges, bits ending on
   a word; exact); then the
   zstd main path runs again, its launches counted from there, and its
   frame must equal the host-entropy frame, decode natively, and both
   kernels must have been launched by that run (a 1 MiB cut must also
   decode with the python oracle);
7. zstd extract: the Writer with the port's engine writes the 64 MiB corpus
   as one zstd level-3 entry (16 frames); a first read through the kernels'
   Python wrappers (``zstd_python_route``, the route of the CPU and of a
   mesh), its launches counted from there, records the inputs
   of every kernel it launches (each once); the Huffman decode, FSE decode
   and repeat-offset kernels, the assembly's stitch, layout and trim (every
   output, the check record and the literal rows), and the replay on the
   zstd frame rows, are held against their plain versions on them (exact)
   and timed, the FSE decode on the adversarial batches of
   ``kernels/fse_cases.py`` (every table mode, one sequence, the corrupt
   streams, 0 to 3,000 sequences in one launch, a row above the
   shared-memory stage read from global memory; exact), and the Huffman
   decode on those of ``kernels/huffman_cases.py`` (every table width, no
   and one symbol, over-read and unconsumed streams, shared tables,
   scattered destinations, malformed rows, a row above the stage among
   1,000 short ones; exact); then
   ``Reader.read_file`` of the entry runs twice, its launches counted from
   there and the codec's fallback count at zero: the corpus must come back
   (XXH3 verified), every one of those kernels must have been launched, each
   read enqueued from native code (one ``torch.zstd_enqueue`` a read) and no
   step down to the host taken; ``native.zstd_decompress`` of the entry is
   timed for scale; and ``decompress_zstd_device`` must raise
   DecompressError on a frame with one corrupted byte;
8. the tokenizer's other wire formats and its size estimate: the "u16"
   epilogue on the corpus in 8 KiB blocks, the "hash" epilogue at caps 8 and
   16 and the "scatter" epilogue at cap 16 on the corpus in 64 KiB blocks,
   the dictionary path's own windows (the cut's 8 KiB blocks behind the
   dictionary in "pair" mode, its 4 KiB blocks in "u16" mode), and the
   estimate of every one of those launches, each against its plain version
   (exact);
9. the shared-dictionary zstd path: a 2 KiB dictionary trained on the cut's
   first 8 KiB, ``compress_zstd(cut, 3, dictionary=blob)`` at 8 KiB blocks
   ("pair" mode, window 10,240) and at 4 KiB blocks ("u16" mode, window
   6,144), its launches counted from there; the frames must decode to the
   cut with the port's host decoder and the dictionary, and the mode's
   tokenizer must have been launched (every tokenizer launch reduces the
   estimate in its own body, so the estimate's launches are the tokenizer's);
10. LZ4 ``compress`` of the corpus at 8 KiB blocks ("u16" mode), decoded by
    the port's lz4f decoder; ``lz4_torch.entry("cuda")`` called once and
    ``compress_block`` on a 16 KiB sample, decoded by the host block decoder;
11. runs the port's CLI (``c``, then ``t`` and ``x`` with a byte compare);
12. multi-device and multi-host (``phase_mesh``): the mesh of the visible
    cards and a mesh that names cuda:0 twice each give the one-device
    frames (LZ4 of the corpus, zstd of the 16 MiB cut, the 8 KiB
    dictionary frames of the cut's first 4 MiB), with the tokenizer
    launched once a shard a step; the zstd entry extracts with its decode
    batches sharded over each mesh; ``dryrun_multichip(2, ["cuda:0",
    "cuda:0"])``; ``write_archive_parallel`` of the CLI's files reads
    back; two processes share the card over gloo (``chip_smoke.py --rank
    R 2 PORT DIR``) for ``compress_multihost`` of the cut and
    ``build_archive_multihost`` of twelve corpus slices, and agree with
    each other and with this process; ``compress_file_elastic`` with 2
    workers on cuda, one crashed after a chunk, gives the no-fault stream,
    and a checkpoint resume equals an uninterrupted run; prints the times
    beside the card and a JSON ``mesh`` line.  Two shards on one card
    measure the sharding's overhead, not a speed-up;
13. prints one JSON line of per-kernel results (each kernel's launches on
    its path, its error against the plain version, its time, the plain
    version's, and the least time the card could take, ``bound_ms``), then,
    last, ``{"ok": true, "device": {...}}``.

``bound_ms`` is the larger of two times: the bytes of the kernel's inputs and
outputs (each once) over the card's memory rate, and its operations over
their peak rate.  Integer operations are counted at the card's float32 rate
outside the tensor cores; a kernel whose work is a sequential chain per
stream or block (the Huffman decoder, the FSE coders, the LZ4 parse's
token walk, XXH3's scramble a KiB) is bound by its longest chain's steps at
``CHAIN_STEP_NS`` a step, one dependent table load from shared memory or L1
and a few integer operations.  The repeat offsets
are no chain (their maps compose, and the kernels scan them), so they are
bound by their bytes: three or four int32 a sequence.
No single PyTorch call computes any of these functions, so ``library_ms``
is null throughout.

It exits non-zero without printing a result when no GPU is visible or any
phase fails.  It imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS_BYTES = 64 << 20
BLOCK = 64 << 10
ZSTD_BYTES = 16 << 20
#: published peaks of one H100 SXM: HBM3 bytes/s, float32 operations/s
#: outside the tensor cores (the rate integer operations are held to here)
HBM_BPS = 3.35e12
OPS_PER_S = 67e12
#: one step of a sequential decode or encode chain: a dependent table load
#: from shared memory or L1 (about 30 cycles) and a few integer operations
CHAIN_STEP_NS = 20.0
#: the Huffman decode at the zstd extract shape (1,160 streams, longest
#: 2,970 symbols) in the design of one thread a stream, the kernel's launch
#: through its wrapper by CUDA events, on an H100 80GB HBM3 at 700 W
ONE_THREAD_HUFFMAN_MS = 1.120


#: the kernels the launch lines print, zeros included
LZ4_KERNELS = ("lz4_tokenize", "lz4_tokenize_u16", "lz4_tokenize_hash", "lz4_tokenize_scatter",
               "lz4_serialize", "lz4_parse", "lz4_replay")
XXH3_KERNELS = ("xxh3_batch", "xxh3_stream")


def launch_mark():
    """The registry's launch counts now: the mark :func:`launch_counts`
    counts from."""
    from zpack_tpu_torch.utils.observe import launches

    return launches()


def launch_counts(mark, kernels) -> dict:
    """Each of ``kernels``' launches since ``mark``, zeros included."""
    from zpack_tpu_torch.utils.observe import launches

    run = launches(mark)
    return {k: run[k] for k in kernels}


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples and lists allowed; None skipped)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += tensor_bytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(moved: int, ops: float = 0.0, chain_steps: int = 0) -> dict:
    """The least time the card could take: ``moved`` bytes at the memory
    rate against ``ops`` operations at their peak rate or the longest
    chain's steps; ``library_ms`` is null (no PyTorch call computes it)."""
    t_bytes = moved / HBM_BPS * 1e3
    t_ops = max(ops / OPS_PER_S * 1e3, chain_steps * CHAIN_STEP_NS * 1e-6)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def tokenize_bound(blocks, outs, depth: int, capj: int) -> dict:
    """The match finder: the windows in, the wire arrays and the estimate
    out; per byte a hash (about 8 operations) and ``depth`` candidates of up
    to ``capj`` byte compares."""
    return bound(tensor_bytes(blocks, outs) + 8, blocks.numel() * (8.0 + depth * (capj + 2)))


def build_corpus(size: int, seed: int = 0) -> bytes:
    """Deterministic Silesia-like mix, the recipe of ``bench.build_corpus``:
    ~1/3 prose-ish words, ~1/3 structured 32-byte records, ~1/3 noise."""
    rng = np.random.default_rng(seed)
    third = size // 3
    words = [b"compression", b"framework", b"archive", b"entropy", b"stream",
             b"the", b"of", b"and", b"data", b"block", b"pipeline", b"mesh"]
    blob = bytearray()
    while len(blob) < third:
        blob += words[int(rng.integers(len(words)))] + b" "
        if rng.random() < 0.02:
            blob += bytes(rng.integers(0, 256, 8).astype(np.uint8))
    n_rec = third // 32
    rec = np.zeros((n_rec, 32), dtype=np.uint8)
    rec[:, 0] = 0x7F
    rec[:, 1] = np.arange(n_rec) % 17
    rec[:, 2:6] = (np.arange(n_rec)[:, None] >> np.arange(4) * 8).astype(np.uint8)
    rec[:, 6:14] = rng.integers(0, 4, (n_rec, 8)).astype(np.uint8)
    noise = rng.integers(0, 256, third).astype(np.uint8).tobytes()
    return (bytes(blob[:third]) + rec.tobytes() + noise)[:size]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the GPU (CUDA events, one warm-up
    unless ``fn`` has just run)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of the device work of ``fn`` (one warm-up): a sleep
    kernel queued first holds the stream while the host queues every call,
    so the events time the launches back to back and not the host's rate
    of launching them (which bounds :func:`cuda_ms` for a kernel of a few
    microseconds)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 200_000)  # about 0.1 ms of the SM clock a call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the host clock."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def u64_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over int64 tensors holding u64 bits."""
    g = got.cpu().numpy().view(np.uint64).ravel().tolist()
    w = want.cpu().numpy().view(np.uint64).ravel().tolist()
    return max((abs(a - b) for a, b in zip(g, w)), default=0)


def tokenizer_blocks(corpus: bytes, device) -> torch.Tensor:
    """256 blocks of 64 KiB: prose, records, noise (80 each), 15 zero
    blocks and a ragged block (40837 bytes at 64 KiB) padded with zeros."""
    third = len(corpus) // 3
    rows = []
    for base in (0, third, 2 * third):
        rows += [corpus[base + i * BLOCK : base + (i + 1) * BLOCK] for i in range(80)]
    rows += [bytes(BLOCK)] * 15
    tail = BLOCK * 5 // 8 - 123
    rows.append(corpus[:tail] + bytes(BLOCK - tail))
    arr = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(rows), BLOCK)
    return torch.from_numpy(arr.copy()).to(device)


def phase_tokenize(corpus: bytes, device, lz4_torch) -> dict:
    blocks = tokenizer_blocks(corpus, device)
    mb = blocks.numel() / 1e6
    err = 0
    for depth in (2, 8):
        for capj in (8, 16):
            got = lz4_torch.tokenize(blocks, depth, capj)
            want = lz4_torch.tokenize_plain(blocks, depth, capj)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            err = max(err, e)
            print(f"tokenize depth={depth} capj={capj}: "
                  f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e}), "
                  f"{int((want[1] > 0).sum())} match positions")
            if e:
                raise AssertionError(f"tokenize kernel != plain at depth {depth} capj {capj}")
    # the main path's shape: level 1 (depth 2), cap 8, one 256-block step
    ms = cuda_ms(lambda: lz4_torch.tokenize(blocks, 2, 8), 10)
    plain_ms = cuda_ms(lambda: lz4_torch.tokenize_plain(blocks, 2, 8), 3)
    print(f"tokenize (256 x 64 KiB, depth 2, capj 8): kernel {ms:.3f} ms "
          f"({mb / ms * 1e3:.1f} MB/s), plain {plain_ms:.3f} ms "
          f"({mb / plain_ms * 1e3:.1f} MB/s)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **tokenize_bound(blocks, lz4_torch.tokenize(blocks, 2, 8), 2, 8)}


def phase_tokenize_cases(device, lz4_torch) -> dict:
    """Every adversarial window of ``kernels/tokenize_cases.py`` (and its
    mirror image as a second row), in every mode its width admits and at
    every depth it names, and the mixed batches at both CTA shapes: the
    kernel's wire arrays and estimate against the plain versions (exact).
    Returns the largest error per ``kernels`` row (named as the launch
    counters are)."""
    from zpack_tpu_torch.kernels import tokenize_cases

    errs = dict.fromkeys([lz4_torch.launch_key(m) for m in lz4_torch.MODES] + ["lz4_est"], 0)

    def hold(name, blocks, mode, capj, depth, dict_pad):
        got, est = lz4_torch.tokenize_est(blocks, depth, capj, mode, dict_pad)
        want = lz4_torch.tokenize_plain(blocks, depth, capj, mode, dict_pad)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        ee = int((est - lz4_torch.est_plain(want, mode)).abs().max())
        key = lz4_torch.launch_key(mode)
        errs[key], errs["lz4_est"] = max(errs[key], e), max(errs["lz4_est"], ee)
        if e or ee:
            raise AssertionError(f"tokenize kernel != plain on {name!r}: mode {mode} capj {capj} "
                                 f"depth {depth} (max_abs_err {e}, estimate off by {ee})")

    for name, case in tokenize_cases.cases().items():
        blocks = torch.from_numpy(np.stack([case.window, case.window[::-1].copy()])).to(device)
        runs = [(m, c, d) for m, c in tokenize_cases.admitted(case) for d in case.depths]
        for mode, capj, depth in runs:
            hold(name, blocks, mode, capj, depth, case.dict_pad)
        print(f"tokenize case {name!r} (window {len(case.window)}, dictionary {case.dict_pad}): "
              f"equal in {len(runs)} runs (modes x caps x depths {case.depths})")
    for W in (8192, 65536):
        blocks = torch.from_numpy(tokenize_cases.mixed_batch(W)).to(device)
        runs = [(m, c, d) for m, c in tokenize_cases.admitted(tokenize_cases.Case(blocks[0]))
                for d in (1, 2, 8, 64)]
        for mode, capj, depth in runs:
            hold(f"mixed batch {W}", blocks, mode, capj, depth, 0)
        print(f"tokenize mixed batch ({blocks.shape[0]} x {W}): equal in {len(runs)} runs")
    return errs


def phase_replay(corpus: bytes, device, lz4_torch, extract, DeviceCompressor, lz4block) -> dict:
    frame = DeviceCompressor(device).compress(corpus)
    _, comp_blocks, bounds, _ = extract.walk_lz4f(frame)
    rle = [b"a" * 5000 + b"bc" * 2000, b"x" * 65536, b"ab" * 32768,
           (b"0123456789abcdef" * 4096)[:65536]]
    from zpack_tpu_torch.kernels import replay_cases

    batches = {
        "main-path frames": lz4_torch.build_batch(comp_blocks, bounds),
        "rle": lz4_torch.build_batch([lz4block.compress_block(r) for r in rle],
                                     [len(r) for r in rle]),
        **{f"adversarial: {k}": b for k, b in replay_cases.cases().items()},
    }
    err = 0
    result = {}
    for name, batch in batches.items():
        args = [torch.from_numpy(batch[k]).to(device) for k in lz4_torch.REPLAY_ARGS]
        got = lz4_torch.replay(*args, n_out=batch["n_out"])
        want = lz4_torch.replay_plain(*args, n_out=batch["n_out"])
        torch.cuda.synchronize()
        e = max_abs_err([got], [want])
        err = max(err, e)
        nbytes = int(batch["out_len"].sum())
        print(f"replay {name} ({len(batch['n_seq'])} rows x {batch['n_out']} B, "
              f"{int(batch['n_seq'].sum())} sequences): "
              f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e})")
        if e:
            raise AssertionError(f"replay kernel != plain on {name}")
        if name == "main-path frames":
            ms = cuda_ms(lambda: lz4_torch.replay(*args, n_out=batch["n_out"]), 10)
            plain_ms = cuda_ms(lambda: lz4_torch.replay_plain(*args, n_out=batch["n_out"]), 3)
            print(f"replay ({nbytes} decoded bytes): kernel {ms:.3f} ms "
                  f"({nbytes / ms / 1e3:.1f} MB/s), plain {plain_ms:.3f} ms "
                  f"({nbytes / plain_ms / 1e3:.1f} MB/s)")
            result = {"ms": ms, "plain_ms": plain_ms,
                      **bound(tensor_bytes(args, got), tensor_bytes(got))}
    result["max_abs_err"] = err
    return result


def phase_lz4_serialize(corpus: bytes, device, lz4_torch) -> dict:
    """The CUDA block serializer on the main path's step (256 blocks of 64
    KiB in "pair" mode, the tokenizer's tables) and on every case of
    ``kernels/serialize_cases.py`` in both wire modes, against the native
    serializer and the plain version; the wrapper timed by CUDA events, the
    plain version and the native serializer by the host clock."""
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import serialize_cases

    blocks = tokenizer_blocks(corpus, device)
    arrays, _ = lz4_torch.tokenize_est(blocks, 2, lz4_torch.CAPJ, "pair")
    n = blocks.numel()
    got = bytes(lz4_torch.sections(lz4_torch.serialize_sections(blocks, arrays, "pair", n).cpu()))
    rows = blocks.cpu().numpy()
    host = [a.cpu().numpy() for a in arrays]
    t0 = time.perf_counter()
    want = native.lz4_serialize_blocks_packed(rows.tobytes(), "pair", host, BLOCK)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = lz4_torch.serialize_plain(rows, host, "pair", n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not got == want == plain:
        raise AssertionError("lz4_serialize: the kernel, the native serializer and the plain "
                             "version differ on the main path's step")
    # the longest block's sequences, the walker's chain
    longest, off = 0, 0
    while off < len(got):
        size = int.from_bytes(got[off:off + 4], "little")
        if not size >> 31:
            seqs = lz4_torch.parse_block_sequences(got[off + 4:off + 4 + size])[0]
            longest = max(longest, len(seqs))
        off += 4 + (size & 0x7FFFFFFF)
    cases = 0
    for mode in lz4_torch.SERIALIZE_MODES:
        for name, (crows, carrays, cn) in serialize_cases.cases(mode).items():
            buf = lz4_torch.serialize_sections(torch.from_numpy(crows).to(device),
                                               [torch.from_numpy(a).to(device) for a in carrays],
                                               mode, cn)
            cwant = native.lz4_serialize_blocks_packed(crows.reshape(-1)[:cn].tobytes(), mode,
                                                       carrays, crows.shape[1])
            if bytes(lz4_torch.sections(buf.cpu())) != cwant:
                raise AssertionError(f"lz4_serialize on {name!r} ({mode}): kernel != native")
            cases += 1
    ms = cuda_ms(lambda: lz4_torch.serialize_sections(blocks, arrays, "pair", n), 10)
    # blocks and tables in; the sections written to their slots, read and placed
    moved = tensor_bytes(blocks, arrays) + 3 * len(got)
    print(f"lz4_serialize main-path step ({len(rows)} x 64 KiB, {len(got)} section bytes, "
          f"longest block {longest} sequences): equal to the native serializer and the plain "
          f"version; {cases} cases equal to native in both modes; kernel {ms:.3f} ms "
          f"({n / ms / 1e3:.1f} MB/s), native {native_ms:.3f} ms, plain {plain_ms:.3f} ms (host)")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "native_ms": native_ms,
            **bound(moved, chain_steps=longest), "longest_block_sequences": longest,
            "blocks": len(rows), "section_bytes": len(got)}


def phase_lz4_serialize_hc(corpus: bytes, device, lz4_torch) -> dict:
    """The serializer's HC parse (LZ4's high-compression levels) on the
    main path's step, its tables from the match finder at an HC level's
    comparison and at depth 8 and at the cap, and on every case and HC case
    of ``kernels/serialize_cases.py`` in both wire modes: the kernel against
    the native HC serializer and the plain version.  At each depth the
    match finder's tables and estimate first against the plain versions
    (exact), since all three serializers read the same tables.  The match
    finder and the serializer timed by CUDA events at each depth."""
    from zpack_tpu_torch import native
    from zpack_tpu_torch.kernels import serialize_cases

    blocks = tokenizer_blocks(corpus, device)
    n = blocks.numel()
    rows = blocks.cpu().numpy()
    capj = lz4_torch.HC_CAPJ["pair"]
    out = {}
    for depth in (8, lz4_torch.HC_DEPTH_CAP):
        arrays, est = lz4_torch.tokenize_est(blocks, depth, capj, "pair")
        want_arrays = lz4_torch.tokenize_plain(blocks, depth, capj, "pair")
        torch.cuda.synchronize()
        e = max_abs_err(arrays, want_arrays)
        ee = int((est - lz4_torch.est_plain(want_arrays, "pair")).abs().max())
        print(f"tokenize HC depth={depth} capj={capj}, main-path step: "
              f"{'equal' if e == ee == 0 else 'DIFFERENT'} (tables max_abs_err {e}, "
              f"estimate {ee}), {int((want_arrays[1] > 0).sum())} match positions")
        if e or ee:
            raise AssertionError(f"tokenize kernel != plain at depth {depth} capj {capj} "
                                 "on the main path's step")
        del want_arrays
        got = bytes(lz4_torch.sections(
            lz4_torch.serialize_sections(blocks, arrays, "pair", n, "hc").cpu()))
        host = [a.cpu().numpy() for a in arrays]
        t0 = time.perf_counter()
        want = native.lz4_serialize_blocks_hc(rows.tobytes(), "pair", host, BLOCK)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = lz4_torch.serialize_plain(rows, host, "pair", n, "hc")
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not got == want == plain:
            raise AssertionError(f"lz4_serialize (HC) at depth {depth}: the kernel, the native "
                                 "serializer and the plain version differ on the main path's step")
        tok_ms = cuda_ms(lambda: lz4_torch.tokenize_est(blocks, depth, capj, "pair"), 10)
        ms = cuda_ms(lambda: lz4_torch.serialize_sections(blocks, arrays, "pair", n, "hc"), 10)
        greedy = len(lz4_torch.sections(
            lz4_torch.serialize_sections(blocks, arrays, "pair", n).cpu()))
        print(f"lz4_serialize HC, main-path step at depth {depth}, capj {capj}: {len(got)} "
              f"section bytes (greedy {greedy}), equal to the native HC serializer and the "
              f"plain version; kernel {ms:.3f} ms, tokenize {tok_ms:.3f} ms, native "
              f"{native_ms:.3f} ms, plain {plain_ms:.3f} ms (host)")
        out[f"depth_{depth}"] = {"ms": ms, "tokenize_ms": tok_ms, "native_ms": native_ms,
                                 "tokenize_max_abs_err": e, "est_err": ee,
                                 "plain_ms": plain_ms, "section_bytes": len(got),
                                 "greedy_section_bytes": greedy}
    cases = 0
    for mode in lz4_torch.SERIALIZE_MODES:
        both = serialize_cases.cases(mode) | serialize_cases.hc_cases(mode)
        for name, (crows, carrays, cn) in both.items():
            buf = lz4_torch.serialize_sections(torch.from_numpy(crows).to(device),
                                               [torch.from_numpy(a).to(device) for a in carrays],
                                               mode, cn, "hc")
            cwant = native.lz4_serialize_blocks_hc(crows.reshape(-1)[:cn].tobytes(), mode,
                                                   carrays, crows.shape[1])
            if (bytes(lz4_torch.sections(buf.cpu())) != cwant
                    or lz4_torch.serialize_plain(crows, carrays, mode, cn, "hc") != cwant):
                raise AssertionError(f"lz4_serialize (HC) on {name!r} ({mode}): the kernel, the "
                                     "native serializer and the plain version differ")
            cases += 1
    print(f"lz4_serialize HC: {cases} cases equal to native and plain in both modes")
    return {**out, "cases": cases}


def phase_lz4_parse(corpus: bytes, device, lz4_torch, extract, DeviceCompressor) -> dict:
    """The CUDA block parse against ``build_batch`` on the main path's
    blocks and on every batch of ``kernels/lz4_parse_cases.py`` (tables
    exact, errors the same message); the wrapper, the walk (its launch, and
    its chain and values steps each alone) and the layout timed by CUDA
    events, ``build_batch`` by the host clock; the walkers resident at once
    beside the blocks."""
    from zpack_tpu_torch.errors import DecompressError
    from zpack_tpu_torch.kernels import lz4_parse_cases

    frame = DeviceCompressor(device).compress(corpus)
    _, blocks, bounds, _ = extract.walk_lz4f(frame)
    flat, offsets = lz4_torch.pack_blocks(blocks, pin=True)
    payload = flat.to(device)

    def outcome(fn):
        try:
            return fn(), None
        except DecompressError as e:
            return None, str(e)

    def hold(name, blocks, sizes, payload, offsets, plain=None):
        want, werr = plain or outcome(lambda: lz4_torch.build_batch(blocks, sizes))
        got, err = outcome(lambda: lz4_torch.parse_batch(payload, offsets, sizes))
        torch.cuda.synchronize()
        if err != werr:
            raise AssertionError(f"lz4_parse on {name!r}: kernel raises {err!r}, "
                                 f"build_batch {werr!r}")
        if err is not None:
            return 0, got, want
        e = max_abs_err([got[k] for k in lz4_torch.REPLAY_ARGS],
                        [torch.from_numpy(want[k]).to(device) for k in lz4_torch.REPLAY_ARGS])
        if e or got["n_out"] != want["n_out"] or any(
                got[k].shape != want[k].shape for k in lz4_torch.REPLAY_ARGS):
            raise AssertionError(f"lz4_parse kernel != build_batch on {name!r} "
                                 f"(max_abs_err {e})")
        return e, got, want

    t0 = time.perf_counter()
    plain = outcome(lambda: lz4_torch.build_batch(blocks, bounds))
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, got, want = hold("main-path blocks", blocks, bounds, payload, offsets, plain)
    longest = int(want["n_seq"].max())
    print(f"lz4_parse main-path blocks ({len(blocks)} blocks, {len(flat)} bytes, "
          f"{int(want['n_seq'].sum())} sequences, longest {longest}; tables "
          f"{tuple(want['seg_start'].shape)}, {tuple(want['lit_bytes'].shape)}): "
          f"equal to build_batch (max_abs_err {err})")
    for name, case in lz4_parse_cases.cases().items():
        f, o = lz4_torch.pack_blocks(case.blocks)
        e, _, _ = hold(name, case.blocks, case.sizes, f.to(device), o)
        err = max(err, e)
    print(f"lz4_parse cases: equal to build_batch on all "
          f"{len(lz4_parse_cases.cases())} batches, the same errors")
    ms = cuda_ms(lambda: lz4_torch.parse_batch(payload, offsets, bounds), 10)
    walk = lz4_torch._parse_walk(payload, offsets)
    info = walk["info"].clone()
    walk_ms = cuda_ms(lambda: lz4_torch._parse_walk(payload, offsets), 10)
    launch_ms = cuda_ms(lambda: lz4_torch._walk_launch(payload, walk, 3), 10)
    chain_ms = cuda_ms(lambda: lz4_torch._walk_launch(payload, walk, 1), 10)
    values_ms = cuda_ms(lambda: lz4_torch._walk_launch(payload, walk, 2), 10)
    torch.cuda.synchronize()
    if not torch.equal(walk["info"], info):
        raise AssertionError("lz4_parse: the chain and values steps apart differ from both at once")
    bp, S = want["seg_start"].shape
    L = want["lit_bytes"].shape[1]
    layout_ms = cuda_ms(lambda: lz4_torch._parse_layout(payload, walk, bp, S, L), 10)
    plan = walk["plan"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"lz4_parse walk: longest row {int(np.diff(offsets).max())} bytes; {len(blocks)} blocks "
          f"in {plan['ctas']} CTAs of {plan['group']} rows, a {plan['smem']}-byte stage, "
          f"{plan['per_sm']} CTAs an SM x {sms} SMs: {plan['resident']} walkers resident at "
          f"once for {len(blocks)} blocks ({plan['waves']} wave(s))")
    print(f"lz4_parse (main-path blocks): through the wrapper {ms:.3f} ms, walk {walk_ms:.3f} ms "
          f"(its launch {launch_ms:.3f}; the chain step alone {chain_ms:.3f}, "
          f"{chain_ms * 1e6 / max(longest, 1):.1f} ns a step of the longest block; the values "
          f"step alone {values_ms:.3f}; each with its staging), layout {layout_ms:.3f} ms; "
          f"build_batch {plain_ms:.3f} ms (host)")
    outs = [got[k] for k in lz4_torch.REPLAY_ARGS]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(tensor_bytes(payload, outs) + 16 * len(blocks), chain_steps=longest),
            "walk_ms": walk_ms, "walk_launch_ms": launch_ms, "chain_ms": chain_ms,
            "values_ms": values_ms, "layout_ms": layout_ms,
            "walk_ns_per_step": walk_ms * 1e6 / max(longest, 1),
            "chain_ns_per_step": chain_ms * 1e6 / max(longest, 1),
            "longest_block_sequences": longest, "blocks": len(blocks),
            "walkers_resident": plan["resident"], "rows_a_cta": plan["group"]}


XXH3_EDGES = (241, 255, 256, 257, 1024, 1025, 1088, 1089, 16384, 16385, 65536)
XXH3_STREAM_LENGTHS = (241, 1024, 1025, 65536, 200001)


def xxh3_sets(corpus: bytes) -> dict:
    """The Pallas bench shape (128 streams of 512 KiB, ``tpu_bench.py``), a
    many-small-files set (10,000 lengths log-uniform in 241..65536 from
    ``default_rng(0)`` plus the edge lengths, each cut from the corpus), and
    8 streams of 8 MiB (the corpus in eighths: long rows in a small batch)."""
    slen = 512 << 10
    rng = np.random.default_rng(0)
    lengths = np.exp(rng.uniform(np.log(241), np.log(65536), 10000))
    lengths = np.concatenate([np.clip(lengths.astype(np.int64), 241, 65536), XXH3_EDGES])
    starts = rng.integers(0, len(corpus) - lengths + 1)
    eighth = len(corpus) // 8
    return {
        "128 x 512 KiB": [corpus[i * slen:(i + 1) * slen] for i in range(128)],
        f"{len(lengths)} files of 241..65536 B": [
            corpus[a:a + n] for a, n in zip(starts.tolist(), lengths.tolist())],
        "8 x 8 MiB": [corpus[i * eighth:(i + 1) * eighth] for i in range(8)],
    }


def phase_xxh3_batch(sets: dict, device, xxh3_torch, H) -> dict:
    """The many-stream kernel against its plain version and the native host
    XXH3 on each set, timed with its plain version and the entry point; its
    grid (a CTA a row) printed beside the SMs.  The first set is the
    ``kernels`` row; the others add their ``ms`` and ``bound_ms`` to it."""
    secret = xxh3_torch.secret_tensor(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    err = 0
    result = {}
    for name, streams in sets.items():
        n = len(streams)
        mb = sum(map(len, streams)) / 1e6
        flat, offsets = xxh3_torch.split_packed(xxh3_torch.pack(streams).to(device), n)
        acc, hashes = xxh3_torch.accumulate_batch(flat, offsets, secret)
        want_acc, want_hashes = xxh3_torch.hash_batch_plain(flat, offsets)
        torch.cuda.synchronize()
        e = max(u64_err(acc, want_acc), u64_err(hashes, want_hashes))
        err = max(err, e)
        host = [H.xxh3_64(s) for s in streams]
        host_equal = hashes.cpu().numpy().view(np.uint64).tolist() == host
        print(f"xxh3_batch {name} ({n} streams, {mb:.3f} MB): acc and hash "
              f"{'equal' if e == 0 else 'DIFFERENT'} to plain (max_abs_err {e}), "
              f"hashes {'equal' if host_equal else 'DIFFERENT'} to the native host XXH3")
        if e or not host_equal:
            raise AssertionError(f"xxh3_batch kernel disagrees on {name}")
        shape = xxh3_torch.batch_shape(n)
        print(f"xxh3_batch {name}: grid {shape['grid']} CTAs of {shape['threads']} threads, "
              f"{shape['per_sm']} an SM x {sms} SMs")
        ms = cuda_ms(lambda: xxh3_torch.accumulate_batch(flat, offsets, secret), 10)
        plain_ms = cuda_ms(lambda: xxh3_torch.hash_batch_plain(flat, offsets), 1, warmup=False)
        native_ms = host_ms(lambda: [H.xxh3_64(s) for s in streams], 3)
        e2e_ms = host_ms(lambda: xxh3_torch.xxh3_64_batch(streams, device), 3)
        buf = xxh3_torch.pack(streams)
        pack_ms = host_ms(lambda: xxh3_torch.pack(streams), 3)
        h2d_ms = host_ms(lambda: (buf.to(device), torch.cuda.synchronize()), 3)
        b = bound(tensor_bytes(flat, offsets, secret, acc, hashes), flat.numel(),
                  chain_steps=-(-max(map(len, streams)) // 1024))
        print(f"xxh3_batch {name}: kernel {ms:.3f} ms ({mb / ms * 1e3:.1f} MB/s; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}), "
              f"plain {plain_ms:.3f} ms ({mb / plain_ms * 1e3:.1f} MB/s), "
              f"host native loop {native_ms:.3f} ms ({mb / native_ms * 1e3:.1f} MB/s), "
              f"xxh3_64_batch end to end {e2e_ms:.3f} ms ({mb / e2e_ms * 1e3:.1f} MB/s; "
              f"of which pack {pack_ms:.3f} ms, h2d {h2d_ms:.3f} ms)")
        if not result:  # the Pallas bench shape is the kernel's row
            result = {"ms": ms, "plain_ms": plain_ms, **b, "grid_ctas": shape["grid"],
                      "ctas_per_sm": shape["per_sm"]}
        else:
            key = "files" if "files" in name else "rows_" + name.replace(" ", "")
            result.update({f"{key}_ms": ms, f"{key}_bound_ms": b["bound_ms"]})
    result["max_abs_err"] = err
    return result


def phase_xxh3_cases(device, xxh3_torch, H) -> int:
    """Every batch of ``kernels/xxh3_cases.py``: the kernel's accumulators
    and hashes of the valid rows against the plain version's and the native
    host XXH3, zeros for the rejected rows (exact).  Returns the largest
    error."""
    from zpack_tpu_torch.kernels import xxh3_cases

    secret = xxh3_torch.secret_tensor(device)
    err = 0
    for name, case in xxh3_cases.cases().items():
        flat, rows = torch.from_numpy(case.flat).to(device), torch.from_numpy(case.rows).to(device)
        valid = torch.from_numpy(case.valid).to(device)
        acc, hashes = xxh3_torch.accumulate_batch(flat, rows, secret)
        want_acc, want_hashes = xxh3_torch.hash_batch_plain(flat, rows[valid])
        torch.cuda.synchronize()
        e = max(u64_err(acc[valid], want_acc), u64_err(hashes[valid], want_hashes),
                u64_err(acc[~valid], torch.zeros_like(acc[~valid])),
                u64_err(hashes[~valid], torch.zeros_like(hashes[~valid])))
        err = max(err, e)
        host_equal = hashes[valid].cpu().numpy().view(np.uint64).tolist() == [
            H.xxh3_64(s) for s in xxh3_cases.streams(case)]
        print(f"xxh3 case {name!r}: {len(case.rows)} rows ({int((~case.valid).sum())} rejected), "
              f"longest {int(case.rows[:, 1].max())} B: "
              f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e}), hashes "
              f"{'equal' if host_equal else 'DIFFERENT'} to the native host XXH3")
        if e or not host_equal:
            raise AssertionError(f"xxh3_batch kernel != plain on case {name!r}")
    return err


def phase_xxh3_stream(corpus: bytes, device, xxh3_torch, H) -> dict:
    secret = xxh3_torch.secret_tensor(device)
    err = 0
    cuts = [corpus[12345:12345 + n] for n in XXH3_STREAM_LENGTHS] + [corpus]
    for raw in cuts:
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
        acc, hashes = xxh3_torch.accumulate_stream(data, secret)
        want_acc, want_hashes = xxh3_torch.hash_stream_plain(data)
        torch.cuda.synchronize()
        e = max(u64_err(acc, want_acc), u64_err(hashes, want_hashes))
        err = max(err, e)
        host_equal = hashes.cpu().numpy().view(np.uint64).tolist() == [H.xxh3_64(raw)]
        print(f"xxh3_stream {len(raw)} B: acc and hash {'equal' if e == 0 else 'DIFFERENT'} "
              f"to plain (max_abs_err {e}), hash {'equal' if host_equal else 'DIFFERENT'} "
              f"to the native host XXH3")
        if e or not host_equal:
            raise AssertionError(f"xxh3_stream kernel disagrees at {len(raw)} bytes")
    mb = len(corpus) / 1e6
    ms = cuda_ms(lambda: xxh3_torch.accumulate_stream(data, secret), 10)
    plain_ms = cuda_ms(lambda: xxh3_torch.hash_stream_plain(data), 1, warmup=False)
    native_ms = host_ms(lambda: H.xxh3_64(corpus), 3)
    e2e_ms = host_ms(lambda: xxh3_torch.xxh3_64(corpus, device), 3)
    print(f"xxh3_stream {len(corpus)} B: kernel {ms:.3f} ms ({mb / ms * 1e3:.1f} MB/s), "
          f"plain {plain_ms:.3f} ms ({mb / plain_ms * 1e3:.1f} MB/s), "
          f"host native {native_ms:.3f} ms ({mb / native_ms * 1e3:.1f} MB/s), "
          f"xxh3_64 end to end {e2e_ms:.3f} ms ({mb / e2e_ms * 1e3:.1f} MB/s)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(tensor_bytes(data, secret, acc, hashes), data.numel(),
                    chain_steps=-(-data.numel() // 1024))}


def phase_xxh3_main(files: list[bytes], corpus: bytes, device, xxh3_torch, H) -> dict:
    """The XXH3 entry points over an archive's entries as the system writes
    them: every device hash must equal the entry's CDR hash."""
    from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer

    store = CompressOptions(CompressionMethod.NONE)
    t0 = time.perf_counter()
    w = Writer.to_heap()
    w.write_archive([(f"f{i:05d}.bin", data, store) for i, data in enumerate(files)])
    t_write = time.perf_counter() - t0
    buf = w.buffer
    entries = Reader.from_memory(buf, shared=True).file_entries
    if len(entries) != len(files) or any(e.comp_method != CompressionMethod.NONE for e in entries):
        raise AssertionError("archive entries are not the stored files")
    datas = [bytes(buf[e.offset:e.offset + e.comp_size]) for e in entries]
    mark = launch_mark()
    t0 = time.perf_counter()
    got = xxh3_torch.xxh3_64_batch(datas, device)
    t_batch = time.perf_counter() - t0
    whole = xxh3_torch.xxh3_64(corpus, device)
    launches = launch_counts(mark, XXH3_KERNELS)
    print(f"xxh3 main path launches: {json.dumps(launches)}")
    if got != [e.hash for e in entries]:
        raise AssertionError("xxh3_64_batch disagrees with the archive's CDR hashes")
    if whole != H.xxh3_64(corpus):
        raise AssertionError("xxh3_64 disagrees with the native host XXH3 on the corpus")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"xxh3 main path never launched {k}")
    print(f"xxh3 archive: {len(entries)} stored entries ({len(buf)} archive bytes, written "
          f"in {t_write:.3f} s); xxh3_64_batch equals every CDR hash ({t_batch * 1e3:.3f} ms); "
          f"xxh3_64 of the corpus equals the native host XXH3")
    return launches


def phase_main_path(corpus: bytes, device) -> dict:
    from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer, codecs
    from zpack_tpu_torch.codecs.lz4 import frame as lz4frame
    from zpack_tpu_torch.utils.observe import metrics

    # nothing installed: the Writer and the Reader take the GPU by default
    if codecs.device() != device:
        raise AssertionError(f"the codecs' default device is {codecs.device()!r}, not {device!r}")
    metrics.reset()
    mark = launch_mark()
    for rep in (1, 2):
        t0 = time.perf_counter()
        w = Writer.to_heap()
        w.write_archive([("bench.bin", corpus, CompressOptions(CompressionMethod.LZ4, 1))])
        t_create = time.perf_counter() - t0
        buf = w.buffer
        t0 = time.perf_counter()
        r = Reader.from_memory(buf, shared=True)
        out = r.read_file("bench.bin")  # verifies the entry's XXH3
        t_extract = time.perf_counter() - t0
        if out != corpus:
            raise AssertionError("main path: round trip bytes differ")
        mb = len(corpus) / 1e6
        print(f"main path rep {rep}: create {mb / t_create:.2f} MB/s "
              f"({t_create:.3f} s), extract {mb / t_extract:.2f} MB/s "
              f"({t_extract:.3f} s), round trip {2 * mb / (t_create + t_extract):.2f} MB/s, "
              f"ratio {len(corpus) / len(buf):.4f} ({len(buf)} archive bytes)")
    launches = launch_counts(mark, LZ4_KERNELS)
    print("main path phases: " + json.dumps(metrics.snapshot(), sort_keys=True))
    print(f"main path launches: {json.dumps(launches)}")
    for k in ("lz4_tokenize", "lz4_serialize", "lz4_parse", "lz4_replay"):
        if launches[k] <= 0:
            raise AssertionError(f"main path never launched {k}")
    e = r.get_file_entry("bench.bin")
    raw = bytes(buf[e.offset : e.offset + e.comp_size])
    if lz4frame.decompress_frame(raw, len(corpus)) != corpus:
        raise AssertionError("host decoder disagrees with the port's frame")
    print("main path: bytes equal, XXH3 verified, host decoder reads the port's frame")
    return launches


def zstd_cut(corpus: bytes, size: int) -> bytes:
    """The first ``size / 3`` bytes of each third of the corpus (prose,
    records, noise), so that Huffman-heavy, sequence-heavy and raw zstd
    blocks all occur."""
    third = len(corpus) // 3
    return b"".join(corpus[base:base + size // 3] for base in (0, third, 2 * third))


def record_zstd_batches(cut: bytes, device, DeviceCompressor, huffman_torch, fse_torch) -> dict:
    """One ``compress_zstd`` run whose encoders keep what they are given: the
    inputs of the two kernel checks, at the main path's shapes.  Huffman:
    ``huffman_calls``, each call of the encoder by ``encode_literal_sections``
    (``(method, items, tables)``), and ``huffman``, the batch of each."""
    calls = []

    class Huffman(huffman_torch.TorchHuffmanEncoder):
        batches: list = []

        def encode_batch(self, streams, tables):
            calls.append(("encode_batch", streams, tables))
            return super().encode_batch(streams, tables)

        def encode_4stream_batch(self, blocks, tables):
            calls.append(("encode_4stream_batch", blocks, tables))
            return super().encode_4stream_batch(blocks, tables)

        def _payloads(self, batch):
            self.batches.append(batch)
            return super()._payloads(batch)

    class Sequences(fse_torch.TorchSequenceEncoder):
        batches: list = []

        def encode_batch(self, blocks, tables):
            self.batches.append(fse_torch.build_batch(blocks, tables))
            return super().encode_batch(blocks, tables)

    dc = DeviceCompressor(device)
    dc._huff_enc, dc._fse_enc = Huffman(device), Sequences(device)
    t0 = time.perf_counter()
    frame = dc.compress_zstd(cut, 3)
    print(f"zstd first run (records the entropy batches): {time.perf_counter() - t0:.3f} s, "
          f"{len(Huffman.batches)} Huffman and {len(Sequences.batches)} FSE batches")
    if not Huffman.batches or not Sequences.batches:
        raise AssertionError("the zstd main path built no Huffman or no FSE batch")
    return {"huffman": Huffman.batches, "huffman_calls": calls, "fse": Sequences.batches,
            "frame": frame}


def huffman_steps(calls: list, device, huffman_torch, reps: int = 7) -> dict:
    """The Huffman encoder's steps on the recorded calls, medians of ``reps``
    ms on the host clock: ``encode``, the encoder's calls whole; then each
    step of them apart: ``build_batch`` (``build_batch`` or
    ``build_4stream_batch``), ``pack_tables`` (a part of it, on the calls'
    distinct tables), ``h2d``, the upload of the batch's arrays, ``launch``
    (``encode_streams`` through its wrapper, ended by a synchronise) and
    ``d2h``, the download of the plane and ``total_bits``; ``rest``, the cut
    into payloads and the checks, is ``encode`` less the others."""
    build = {"encode_batch": huffman_torch.build_batch,
             "encode_4stream_batch": lambda *a: huffman_torch.build_4stream_batch(*a)[0]}
    enc = huffman_torch.TorchHuffmanEncoder(device)
    out = {k: [] for k in ("encode", "build_batch", "pack_tables", "h2d", "launch", "d2h")}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for method, items, tables in calls:
            getattr(enc, method)(items, tables)
        torch.cuda.synchronize()
        out["encode"].append(time.perf_counter() - t0)
        sums = dict.fromkeys(out, 0.0)
        for method, items, tables in calls:
            t = [time.perf_counter()]
            huffman_torch.pack_tables(huffman_torch._distinct(tables)[1])
            t.append(time.perf_counter())
            batch = build[method](items, tables)
            t.append(time.perf_counter())
            args = [torch.from_numpy(batch[k]).to(device) for k in huffman_torch.BATCH_ARGS]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            words, total = huffman_torch.encode_streams(*args, n_words=batch["n_words"])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            words.cpu().numpy(), total.cpu().numpy()
            t.append(time.perf_counter())
            for k, a, b in zip(("pack_tables", "build_batch", "h2d", "launch", "d2h"), t, t[1:]):
                sums[k] += b - a
        for k in sums:
            if k != "encode":
                out[k].append(sums[k])
    med = {k: float(np.median(v)) * 1e3 for k, v in out.items()}
    med["rest"] = med["encode"] - sum(med[k] for k in ("build_batch", "h2d", "launch", "d2h"))
    return med


def _check_batches(name: str, batches: list, device, kernel, plain, args: tuple,
                   total_ok, chain_steps: int = 0, ops_per_item: float = 0.0,
                   streams=lambda b: len(b["word_off"]) - 1) -> dict:
    """Hold ``kernel`` against ``plain`` on every batch (words and
    total_bits exact, and ``total_ok(total_bits, batch)`` true); time one
    pass over all batches."""
    tensors = [[torch.from_numpy(b[k]).to(device) for k in args] for b in batches]

    def run(fn):
        return [fn(*t, n_words=b["n_words"]) for t, b in zip(tensors, batches)]

    got, want = run(kernel), run(plain)
    torch.cuda.synchronize()
    err = 0
    for (gw, gt), (ww, wt), b in zip(got, want, batches):
        err = max(err, int((gw.long() - ww.long()).abs().max()) if gw.numel() else 0,
                  int((gt.long() - wt.long()).abs().max()))
        if not total_ok(gt.cpu().numpy().astype(np.int64), b):
            raise AssertionError(f"{name}: total_bits disagree with the host's bound or count")
    rows = sum(streams(b) for b in batches)
    print(f"{name} ({len(batches)} batches, {rows} streams, "
          f"{sum(b['n_words'] for b in batches)} words): "
          f"{'equal' if err == 0 else 'DIFFERENT'} to plain (max_abs_err {err})")
    if err:
        raise AssertionError(f"{name} kernel != plain on the zstd main path's batches")
    ms = cuda_ms(lambda: run(kernel), 10)
    plain_ms = cuda_ms(lambda: run(plain), 2, warmup=False)
    print(f"{name}: through the wrapper {ms:.4f} ms, plain {plain_ms:.3f} ms (all batches of "
          f"one run)")
    items = sum(len(b[args[0]]) for b in batches)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(tensor_bytes(tensors, got), ops_per_item * items, chain_steps)}


def phase_huffman(rec: dict, device, huffman_torch) -> dict:
    """The Huffman encode kernel on the main path's batches: against the
    plain version (exact) and the host's bit counts; timed through its
    wrapper (``ms``, one pass over the batches, host included), and on the
    device alone (:func:`queued_ms`): its launch with the outputs made once
    (``launch_ms``) and an empty kernel launched on the same grid
    (``floor_ms``); then the encoder's host steps on the recorded calls."""
    batches = rec["huffman"]
    ns = np.concatenate([b["rows"][:, 1] for b in batches])
    lengths = {"streams": int(ns.size), "symbols": int(ns.sum()), "longest": int(ns.max()),
               "median": float(np.median(ns)), "mean": float(ns.mean()),
               "over_4096": int((ns > 4096).sum()), "shortest": int(ns.min())}
    print("huffman_encode streams: " + json.dumps(lengths))
    res = _check_batches("huffman_encode", batches, device, huffman_torch.encode_streams,
                         huffman_torch.encode_streams_plain, huffman_torch.BATCH_ARGS,
                         lambda total, b: np.array_equal(total, b["rows"][:, 3]),
                         ops_per_item=8.0,  # a table load, a shift, an or, a scan share
                         streams=lambda b: len(b["rows"]))
    runs = []
    for b in batches:
        args = [torch.from_numpy(b[k]).to(device) for k in huffman_torch.BATCH_ARGS]
        runs.append((args, torch.empty(b["n_words"], dtype=torch.int32, device=device),
                     torch.empty(len(b["rows"]), dtype=torch.int32, device=device)))
    lib = huffman_torch._build.lib()
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        for args, words, total in runs:
            huffman_torch._encode_launch(args, words, total)

    def floor():
        for args, _, _ in runs:
            huffman_torch._build.check(lib.zp_launch_floor(args[1].shape[0], stream), "floor")

    launch_ms, floor_ms = queued_ms(launch, 50), queued_ms(floor, 50)
    ctas = sum(len(b["rows"]) for b in batches)
    tables = sum(len(b["tables"]) for b in batches)
    steps = huffman_steps(rec["huffman_calls"], device, huffman_torch)
    print(f"huffman_encode on the device alone: the launch {launch_ms:.4f} ms, an empty kernel on "
          f"the same grid ({ctas} CTAs of 256) {floor_ms:.4f} ms; {tables} tables staged")
    print("huffman_encode host steps (ms, median of 7): " + json.dumps(steps))
    res.update({"launch_ms": launch_ms, "floor_ms": floor_ms, "ctas": ctas, "tables": tables,
                "longest_stream": lengths["longest"], "median_stream": lengths["median"],
                "host_steps_ms": steps})
    return res


def phase_huffman_encode_cases(device, huffman_torch) -> int:
    """Every batch of ``kernels/huffman_encode_cases.py``: the Huffman encode
    kernel's words and ``total_bits`` against the plain version's (exact),
    and ``total_bits`` against the host's counts.  Returns the largest
    error."""
    from zpack_tpu_torch.kernels import huffman_encode_cases

    err = 0
    for name, case in huffman_encode_cases.cases().items():
        b = huffman_encode_cases.batch(case)
        args = [torch.from_numpy(b[k]).to(device) for k in huffman_torch.BATCH_ARGS]
        got = huffman_torch.encode_streams(*args, n_words=b["n_words"])
        want = huffman_torch.encode_streams_plain(*args, n_words=b["n_words"])
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        ns = b["rows"][:, 1]
        print(f"huffman_encode case {name!r}: {len(ns)} streams, {int(ns.sum())} symbols "
              f"(longest {int(ns.max())}): "
              f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e})")
        if e or not np.array_equal(got[1].cpu().numpy(), b["rows"][:, 3]):
            raise AssertionError(f"huffman_encode kernel != plain on case {name!r}")
    return err


def phase_fse(batches: list, device, fse_torch) -> dict:
    nseq = sum(len(b["fields"]) for b in batches)
    longest = max(int((b["seq_off"][1:] - b["seq_off"][:-1]).max()) for b in batches)
    print(f"fse_encode input: {nseq} sequences, longest block {longest}")
    res = _check_batches("fse_encode", batches, device, fse_torch.encode_seq_streams,
                         fse_torch.encode_seq_streams_plain, fse_torch.BATCH_ARGS,
                         lambda total, b: bool((total + 1 <= b["ub_bits"]).all()),
                         chain_steps=longest)
    # the launch alone, and its state walk and its packing each alone (their
    # outputs mean nothing), over the batches with their outputs made once
    runs = []
    for b in batches:
        args = [torch.from_numpy(b[k]).to(device) for k in fse_torch.BATCH_ARGS]
        words = torch.zeros(b["n_words"], dtype=torch.int32, device=device)
        total = torch.empty(len(b["seq_off"]) - 1, dtype=torch.int32, device=device)
        runs.append((args, words, total))

    def launch(steps):
        for args, words, total in runs:
            fse_torch._encode_launch(args, words, total, steps)

    launch_ms, chain_ms, fields_ms = (cuda_ms(lambda: launch(s), 10) for s in (3, 1, 2))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sum(len(b["seq_off"]) - 1 for b in batches)
    stage = max(fse_torch.encode_stage(len(b["fields"])) for b in batches)
    resident = fse_torch.encode_ctas_per_sm(stage) * sms
    print(f"fse_encode steps: the launch {launch_ms:.3f} ms, the state walk alone {chain_ms:.3f} "
          f"ms ({chain_ms * 1e6 / max(longest, 1):.1f} ns a step of the longest block), the "
          f"packing alone {fields_ms:.3f} ms; {blocks} blocks, a stage of {stage} sequences: "
          f"{resident} CTAs resident at once")
    res.update({"launch_ms": launch_ms, "chain_ms": chain_ms, "fields_ms": fields_ms,
                "chain_ns_per_step": chain_ms * 1e6 / max(longest, 1),
                "longest_block_sequences": longest, "blocks": blocks,
                "ctas_resident": resident})
    return res


def phase_fse_encode_cases(device, fse_torch) -> int:
    """Every batch of ``kernels/fse_encode_cases.py``: the FSE encode
    kernel's words and ``total_bits`` against the plain version's (exact).
    Returns the largest error."""
    from zpack_tpu_torch.kernels import fse_encode_cases

    err = 0
    for name, case in fse_encode_cases.cases().items():
        batch = fse_torch.build_batch(case.blocks, case.tables)
        args = [torch.from_numpy(batch[k]).to(device) for k in fse_torch.BATCH_ARGS]
        got = fse_torch.encode_seq_streams(*args, n_words=batch["n_words"])
        want = fse_torch.encode_seq_streams_plain(*args, n_words=batch["n_words"])
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        ns = np.diff(batch["seq_off"])
        print(f"fse_encode case {name!r}: {len(ns)} blocks, {int(ns.sum())} sequences (longest "
              f"{int(ns.max())}, {'above' if ns.max() > fse_torch.ENCODE_STAGE_CAP else 'within'} "
              f"the stage cap): {'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e})")
        if e:
            raise AssertionError(f"fse_encode kernel != plain on case {name!r}")
    return err


def phase_zstd(cut: bytes, corpus: bytes, first_frame: bytes, device, DeviceCompressor) -> dict:
    from zpack_tpu_torch import native
    from zpack_tpu_torch.codecs.zstd import frame as ZF
    from zpack_tpu_torch.utils.observe import metrics

    dc = DeviceCompressor(device)  # level 1, 64 KiB blocks, as dryrun_multichip
    metrics.reset()
    mark = launch_mark()
    t0 = time.perf_counter()
    frame = dc.compress_zstd(cut, 3)
    t_dev = time.perf_counter() - t0
    launches = launch_counts(mark, ("huffman_encode", "fse_encode"))
    phases = metrics.snapshot()
    print(f"zstd main path launches: {json.dumps(launches)}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"zstd main path never launched {k}")
    mb = len(cut) / 1e6
    print(f"zstd main path ({len(cut)} bytes, device entropy): {mb / t_dev:.2f} MB/s "
          f"({t_dev:.3f} s), ratio {len(cut) / len(frame):.4f} ({len(frame)} bytes)")
    print("zstd main path phases: " + json.dumps(phases, sort_keys=True))
    t0 = time.perf_counter()
    host = dc.compress_zstd(cut, 3, device_entropy=False)
    t_host = time.perf_counter() - t0
    print(f"zstd host-entropy frame: {mb / t_host:.2f} MB/s ({t_host:.3f} s)")
    if frame != host or frame != first_frame:
        raise AssertionError("zstd: the device-entropy frame differs from the host-entropy frame")
    t0 = time.perf_counter()
    out = native.zstd_decompress(frame, len(cut))
    t_dec = time.perf_counter() - t0
    if out != cut:
        raise AssertionError("zstd: the native decoder does not give the cut back")
    small = zstd_cut(corpus, 1 << 20)
    if ZF.decompress(dc.compress_zstd(small, 3)) != small:
        raise AssertionError("zstd: the python oracle does not decode the 1 MiB cut's frame")
    t0 = time.perf_counter()
    nat = native.zstd_compress(cut, 3)
    t_nat = time.perf_counter() - t0
    print(f"zstd: frame equals the host-entropy frame, native decode OK ({t_dec:.3f} s), "
          f"1 MiB frame decodes with the python oracle; for scale only (other bytes): "
          f"native.zstd_compress level 3 {mb / t_nat:.2f} MB/s ({t_nat:.3f} s), "
          f"ratio {len(cut) / len(nat):.4f}")
    return launches


def phase_huffman_cases(device, huffman_torch) -> int:
    """Every batch of ``kernels/huffman_cases.py``: the Huffman decode
    kernel's output and ``final`` against the plain version's (exact).
    Returns the largest error."""
    from zpack_tpu_torch.kernels import huffman_cases

    err = 0
    for name, case in huffman_cases.cases().items():
        b = case.batch
        args = [torch.from_numpy(b[k]).to(device) for k in huffman_torch.DECODE_ARGS]
        got = huffman_torch.decode_streams(*args, n_out=b["n_out"], widest=b["widest"])
        want = huffman_torch.decode_streams_plain(*args, n_out=b["n_out"])
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        print(f"huffman case {name!r}: {len(b['rows'])} rows, {int(b['rows'][:, 3].max())} "
              f"symbols in the longest, widest row {b['widest']} bytes "
              f"({'above' if b['widest'] > huffman_torch.STAGE_CAP else 'within'} the stage cap): "
              f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e})")
        if e:
            raise AssertionError(f"huffman_decode kernel != plain on case {name!r}")
    return err


def phase_fse_cases(device, fse_torch) -> int:
    """Every batch of ``kernels/fse_cases.py``: the FSE decode kernel's five
    outputs against the plain version's (exact).  Returns the largest error."""
    from zpack_tpu_torch.kernels import fse_cases

    err = 0
    for name, case in fse_cases.cases().items():
        batch = fse_torch.build_decode_batch(case.items)
        args = [torch.from_numpy(batch[k]).to(device) for k in fse_torch.DECODE_ARGS]
        got = fse_torch.decode_seq_streams(*args)
        want = fse_torch.decode_seq_streams_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        widest = int(batch["rows"][:, 1].max())
        print(f"fse case {name!r}: {len(case.items)} rows, {int(batch['seq_off'][-1])} sequences "
              f"(longest {int(np.diff(batch['seq_off']).max())}), widest row {widest} bytes "
              f"({'above' if widest > fse_torch.STAGE_CAP else 'within'} the stage cap): "
              f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e})")
        if e:
            raise AssertionError(f"fse_decode kernel != plain on case {name!r}")
    return err


ZSTD_ENTRY = "bench.zst"
#: the kernels of the zstd extract path (launch counter names) and their
#: wrappers; each plain version is the wrapper's name + "_plain"
EXTRACT_KERNELS = {"huffman_decode": "decode_streams", "fse_decode": "decode_seq_streams",
                   "rep_totals": "rep_totals", "rep_apply": "rep_apply",
                   "lz4_replay": "replay_enqueue", "zstd_stitch": "stitch",
                   "zstd_layout": "layout", "zstd_trim": "trim"}
#: the wrapper timed for a recorded one that does not read its result back
TIMED_AS = {"replay_enqueue": "replay"}
#: the assembly's kernels (``kernels/assemble_torch.py``), whose plain
#: versions take host tensors, and the arguments each writes in place (a
#: position or a keyword): they are recorded as copies made before the call
ASSEMBLY_WRITES = {"zstd_stitch": (10,), "zstd_layout": (9, "lits"), "zstd_trim": ()}


def write_zstd_entry(corpus: bytes, device, extract) -> tuple:
    """The corpus as one zstd level-3 entry, written by the Writer with the
    port's engine installed; returns the archive and the entry's bytes."""
    from zpack_tpu_torch import CompressionMethod, CompressOptions, Reader, Writer, engine

    engine.install(device)
    try:
        t0 = time.perf_counter()
        w = Writer.to_heap()
        w.write_archive([(ZSTD_ENTRY, corpus, CompressOptions(CompressionMethod.ZSTD, 3))])
        t_write = time.perf_counter() - t0
    finally:
        engine.uninstall()
    buf = w.buffer
    e = Reader.from_memory(buf, shared=True).get_file_entry(ZSTD_ENTRY)
    comp = bytes(buf[e.offset:e.offset + e.comp_size])
    walk = extract.walk_zstd(comp)
    nseq = [it[4] for it in walk.seq_items]
    print(f"zstd entry: {len(comp)} bytes (ratio {len(corpus) / len(comp):.4f}, written in "
          f"{t_write:.3f} s): {len(walk.frames)} frames, "
          f"{sum(len(b) for _, b, _ in walk.frames)} blocks, {sum(nseq)} sequences in "
          f"{len(nseq)} blocks (longest {max(nseq, default=0)}), {len(walk.streams)} Huffman "
          f"streams of {sum(walk.n_syms)} literals (longest {max(walk.n_syms, default=0)})")
    if len(walk.frames) < 2 or not walk.streams or not nseq:
        raise AssertionError("the zstd entry holds no Huffman literals, sequences or frames")
    return buf, comp


def _copy_written(name: str, args: tuple, kwargs: dict) -> tuple:
    """``(args, kwargs)`` with a copy of each tensor the call writes in
    place, so that they hold its inputs after the run."""
    writes = ASSEMBLY_WRITES.get(name, ())
    args = tuple(a.clone() if i in writes else a for i, a in enumerate(args))
    return args, {k: v.clone() if k in writes else v for k, v in kwargs.items()}


def _assembly_outputs(name: str, fn, args: tuple, kwargs: dict, device) -> list:
    """``fn`` on copies of the recorded arguments on ``device``: its
    results and the tensors it writes in place, on the host; of the
    layout's segment tables the columns segments take (the kernel leaves
    the others unwritten, the replay reads none of them)."""
    move = (lambda t: t.to(device, copy=True) if isinstance(t, torch.Tensor) else t)
    a, kw = [move(t) for t in args], {k: move(v) for k, v in kwargs.items()}
    got = fn(*a, **kw)
    got = list(got) if isinstance(got, tuple) else [got]
    out = [t.cpu() for t in got + [a[w] if isinstance(w, int) else kw[w]
                                   for w in ASSEMBLY_WRITES[name]]]
    if name == "zstd_layout":
        bases, ff = args[2].cpu(), args[1].cpu()
        nseg = bases[ff[1:], 0] - bases[ff[:-1], 0]
        taken = (torch.arange(kwargs["SB"])[None, :] < nseg[:, None]).reshape(-1)
        out[0] = out[0][:, taken]
    return out


def phase_zstd_assembly(calls: dict, device, assemble_torch) -> dict:
    """The assembly's three kernels on the inputs the first run of the zstd
    extract path gave them, against their plain versions on the host:
    every output, the record and the literal rows exactly; each kernel
    timed over 10 launches, its plain version once on the host clock."""
    plains = {"zstd_stitch": assemble_torch.stitch_plain,
              "zstd_layout": assemble_torch.layout_plain,
              "zstd_trim": lambda rows, off, state, rec, total:
                  assemble_torch.trim_plain(rows, off, state, rec)}
    res = {}
    for name, plain in plains.items():
        kernel = getattr(assemble_torch, EXTRACT_KERNELS[name])
        args, kwargs = calls[name][0]
        got = _assembly_outputs(name, kernel, args, kwargs, device)
        torch.cuda.synchronize()
        want = _assembly_outputs(name, plain, args, kwargs, torch.device("cpu"))
        same = [t.shape for t in got] == [t.shape for t in want]
        err = max_abs_err(got, want) if same else -1
        if same and not err and not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = 1  # a difference the int32 view does not show
        print(f"{name} on the zstd extract inputs: {'equal' if err == 0 else 'DIFFERENT'} "
              f"to plain (max_abs_err {err}; {len(got)} outputs)")
        if err:
            raise AssertionError(f"{name} kernel != plain on the zstd extract inputs")
        ms = cuda_ms(lambda: kernel(*args, **kwargs), 10)
        host = [t.cpu() if isinstance(t, torch.Tensor) else t for t in args]
        host_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        plain_ms = host_ms(lambda: plain(*host, **host_kw), 1)
        ops = chain = 0
        if name == "zstd_stitch":  # one CTA: a scan of 8 steps a tile of 256 blocks
            nb = args[0].shape[0]
            moved, ops, chain = tensor_bytes(args, got), 20.0 * nb, -(-nb // 256) * 8
            what = f"{nb} blocks, {args[1].numel() - 1} frames"
        elif name == "zstd_layout":  # the sequences in, the taken columns and runs out
            runs = kwargs["runs"]
            run_bytes = int(runs[:, 0].sum()) if runs.numel() else 0
            moved = tensor_bytes(args[4:7]) + tensor_bytes(got[0]) + 2 * run_bytes
            what = f"{args[4].numel()} sequences, {got[0].shape[1]} segments, " \
                f"{runs.shape[0]} literal runs of {run_bytes} bytes"
        else:  # each frame's bytes read from its row and written out
            moved = 2 * kwargs["total"]
            what = f"{args[1].numel() - 1} frames, {kwargs['total']} bytes"
        b = bound(moved, ops, chain)
        print(f"{name} (zstd extract): {what}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
              f"(host), bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {moved} bytes)")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
    return res


@contextlib.contextmanager
def recording_kernels(modules: dict):
    """Wrap each kernel wrapper of the zstd extract path so that its
    arguments are kept: ``calls[name]`` lists ``(args, kwargs)``."""
    calls: dict = {}
    saved = []
    for name, attr in EXTRACT_KERNELS.items():
        mod = modules[name]
        fn = getattr(mod, attr)

        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls.setdefault(_name, []).append(_copy_written(_name, args, kwargs))
            return _fn(*args, **kwargs)

        setattr(mod, attr, rec)
        saved.append((mod, attr, fn))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def zstd_python_route(extract, comp: bytes, n: int, device) -> bytes:
    """The zstd read through the kernels' Python wrappers on ``device``, the
    route of the CPU and of a mesh, whose calls ``recording_kernels`` sees
    (on a card the read's main path enqueues the same kernels from native
    code, ``kernels/zstd_chain.py``)."""
    return extract._decode_python(extract.zstd_plan(comp), n, torch.device(device))


def phase_zstd_extract_kernels(comp: bytes, corpus: bytes, device, extract, modules) -> dict:
    """Record each kernel's inputs on a first run of the device path
    through the Python wrappers, then hold each kernel against its plain
    version on them and time both (each kernel 10 times, its plain version
    once)."""
    mark = launch_mark()
    with recording_kernels(modules) as calls:
        t0 = time.perf_counter()
        out = zstd_python_route(extract, comp, len(corpus), device)
        print(f"zstd extract first run (records the kernels' inputs): "
              f"{time.perf_counter() - t0:.3f} s")
    if out != corpus:
        raise AssertionError("zstd extract: the first device run does not give the corpus back")
    run = launch_counts(mark, EXTRACT_KERNELS)
    for name in EXTRACT_KERNELS:
        if len(calls.get(name, ())) != 1 or run[name] != 1:
            raise AssertionError(f"zstd extract: {name} was called {len(calls.get(name, ()))} "
                                 f"times and launched {run[name]}, not once")
    res = phase_zstd_assembly(calls, device, modules["zstd_stitch"])
    for name, attr in EXTRACT_KERNELS.items():
        if name in ASSEMBLY_WRITES:
            continue
        attr = TIMED_AS.get(attr, attr)
        kernel, plain = getattr(modules[name], attr), getattr(modules[name], attr + "_plain")
        args, kwargs = calls[name][0]
        got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
        torch.cuda.synchronize()
        got, want = ([got], [want]) if isinstance(got, torch.Tensor) else (got, want)
        err = max_abs_err(got, want)
        print(f"{name} on the zstd extract inputs: {'equal' if err == 0 else 'DIFFERENT'} "
              f"to plain (max_abs_err {err})")
        if err:
            raise AssertionError(f"{name} kernel != plain on the zstd extract inputs")
        ms = cuda_ms(lambda: kernel(*args, **kwargs), 10)
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), 1, warmup=False)
        print(f"{name} (zstd extract): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        ops = chain = 0
        if name == "huffman_decode":
            chain = int(args[1][:, 3].max())  # the longest stream's symbols
            S, widest = args[1].shape[0], kwargs["widest"]
            resident = modules[name].ctas_per_sm(widest) * \
                torch.cuda.get_device_properties(device).multi_processor_count
            print(f"huffman_decode (zstd extract): {S} streams, longest {chain} symbols, widest "
                  f"row {widest} bytes: {'all' if resident >= S else 'not all'} {S} CTAs "
                  f"resident ({resident} fit); the one-thread-a-stream kernel this design "
                  f"replaced took {ONE_THREAD_HUFFMAN_MS:.3f} ms at this shape on an H100 80GB HBM3 "
                  f"at 700 W, this one {ms:.3f} ms")
        elif name == "lz4_replay":
            ops = tensor_bytes(got)  # one copy a byte
        elif name == "fse_decode":  # one walk of the longest block's sequences
            chain = int((args[2][1:] - args[2][:-1]).max())
            print(f"fse_decode (zstd extract): {args[1].shape[0]} blocks, longest {chain} "
                  f"sequences, widest row {int(args[1][:, 1].max())} bytes")
        else:  # rep_totals, rep_apply: a scan, some 20 integer operations a map
            ops = 20.0 * args[0].numel()
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(tensor_bytes(args, got), ops, chain)}
    return res


def phase_zstd_extract_main(buf, comp: bytes, corpus: bytes, device) -> dict:
    """``Reader.read_file`` of the zstd entry, twice, its launches counted
    from there and the codec's fallback count at zero."""
    from zpack_tpu_torch import Reader, engine, native
    from zpack_tpu_torch.codecs import zstd as port_zstd
    from zpack_tpu_torch.utils.observe import metrics

    engine.install(device)
    try:
        port_zstd.reset_fallbacks()
        metrics.reset()
        mark = launch_mark()
        mb = len(corpus) / 1e6
        for rep in (1, 2):
            t0 = time.perf_counter()
            out = Reader.from_memory(buf, shared=True).read_file(ZSTD_ENTRY)  # verifies XXH3
            t = time.perf_counter() - t0
            if out != corpus:
                raise AssertionError("zstd extract main path: bytes differ")
            print(f"zstd extract main path rep {rep}: {mb / t:.2f} MB/s ({t:.3f} s)")
        launches = launch_counts(mark, EXTRACT_KERNELS)
        fallbacks = dict(port_zstd.FALLBACKS)
        snap = metrics.snapshot()
        print("zstd extract main path phases: " + json.dumps(snap, sort_keys=True))
    finally:
        engine.uninstall()
    print(f"zstd extract main path launches: {json.dumps(launches)}, "
          f"fallbacks: {json.dumps(fallbacks)}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"zstd extract main path never launched {k}")
    if any(fallbacks.values()):
        raise AssertionError(f"zstd extract main path fell back: {fallbacks}")
    if snap.get("torch.zstd_enqueue", {}).get("calls") != 2 or "torch.zstd_stage" in snap:
        raise AssertionError("zstd extract main path did not enqueue each read from native code")
    t0 = time.perf_counter()
    nat = native.zstd_decompress(comp, len(corpus))
    t_nat = time.perf_counter() - t0
    if nat != corpus:
        raise AssertionError("native.zstd_decompress does not give the corpus back")
    print(f"zstd extract: bytes equal, XXH3 verified; for scale: native.zstd_decompress "
          f"{len(corpus) / 1e6 / t_nat:.2f} MB/s ({t_nat:.3f} s)")
    return launches


def phase_zstd_corrupt_raises(comp: bytes, corpus: bytes, device, extract) -> None:
    """A corrupted byte makes the device route raise DecompressError, the
    error the codec takes its one step down on."""
    from zpack_tpu_torch.codecs.zstd import frame as zframe
    from zpack_tpu_torch.errors import DecompressError
    from zpack_tpu_torch.parallel.host import _scan_zstd_frames

    start, end, _ = _scan_zstd_frames(comp)[0]
    # zero the last byte of the first block with sequences: its sequence
    # bitstream's sentinel
    pos = start + 4 + zframe.parse_frame_header(comp, start + 4).header_size
    walk = extract.walk_zstd(comp[start:end])
    for b in walk.frames[0][1]:
        bsize = (comp[pos] | comp[pos + 1] << 8 | comp[pos + 2] << 16) >> 3
        pos += 3 + (1 if b.btype == zframe.BLOCK_RLE else bsize)
        if b.slot is not None:
            break
    bad = bytearray(comp)
    bad[pos - 1] = 0
    try:
        extract.decompress_zstd_device(bytes(bad), len(corpus), device=device)
    except DecompressError as e:
        print(f"zstd corrupted frame: a zeroed byte at {pos - 1} makes decompress_zstd_device "
              f"raise DecompressError ({e})")
        return
    raise AssertionError("a corrupted zstd frame did not raise DecompressError")


def corpus_blocks(corpus: bytes, B: int, device) -> torch.Tensor:
    """The corpus, zero-padded to whole blocks, as (nb, B) on the device."""
    nb = -(-len(corpus) // B)
    arr = np.zeros(nb * B, dtype=np.uint8)
    arr[:len(corpus)] = np.frombuffer(corpus, dtype=np.uint8)
    return torch.from_numpy(arr.reshape(nb, B)).to(device)


def phase_epilogues(corpus: bytes, cut: bytes, blob: bytes, device, lz4_torch) -> dict:
    """Each wire format's epilogue, and the estimate every launch reduces,
    against the plain versions at full width: the whole corpus in one
    launch (8,192 blocks of 8 KiB, 1,024 of 64 KiB), and the dictionary
    path's windows as ``phase_dict`` launches them (the cut's 8 KiB blocks
    behind the dictionary in "pair" mode, a window of 10,240 bytes that is
    no power of two; its 4 KiB blocks in "u16" mode).

    Each row's ``ms`` is one launch, which writes the wire arrays and
    reduces the estimate; its ``plain_ms`` is the same work, ``tokenize_plain``
    and then ``est_plain``.  The ``lz4_est`` row is the "u16" dictionary
    launch, and its ``max_abs_err`` the estimate's over every case."""
    from zpack_tpu_torch.codecs.zstd.dict import as_dictionary

    content = torch.frombuffer(bytearray(as_dictionary(blob).content), dtype=torch.uint8).to(device)

    def windows(B: int) -> torch.Tensor:
        data = corpus_blocks(cut, B, device)
        return torch.cat([content.expand(len(data), len(content)), data], dim=1)

    blocks64k = corpus_blocks(corpus, BLOCK, device)
    cases = {
        "lz4_tokenize": [("pair", 8, windows(8192), len(content))],
        "lz4_tokenize_u16": [("u16", 8, blocks64k.view(-1, 8192), 0)],
        "lz4_tokenize_hash": [("hash", 8, blocks64k, 0), ("hash", 16, blocks64k, 0)],
        "lz4_tokenize_scatter": [("scatter", 16, blocks64k, 0)],
        "lz4_est": [("u16", 8, windows(4096), len(content))],
    }
    res = {}
    est_err = 0
    for name, runs in cases.items():
        err = 0
        for mode, capj, blocks, dict_pad in runs:
            got, est = lz4_torch.tokenize_est(blocks, 2, capj, mode, dict_pad)
            want = lz4_torch.tokenize_plain(blocks, 2, capj, mode, dict_pad)
            want_est = lz4_torch.est_plain(want, mode)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            ee = int((est - want_est).abs().max())
            err, est_err = max(err, e), max(est_err, ee)
            shape = f"{blocks.shape[0]} x {blocks.shape[1]}" + (
                f", dictionary {dict_pad}" if dict_pad else "")
            print(f"tokenize mode={mode} capj={capj} ({shape}): "
                  f"{'equal' if e == 0 else 'DIFFERENT'} (max_abs_err {e}); estimate "
                  f"{int(est[0])} {'equal' if ee == 0 else 'DIFFERENT'} to plain")
            if e or ee:
                raise AssertionError(f"tokenize kernel != plain in mode {mode} capj {capj}")
            del want
        # timed at the last run of the case (cap 16 for "hash")
        mb = blocks.numel() / 1e6
        ms = cuda_ms(lambda: lz4_torch.tokenize_est(blocks, 2, capj, mode, dict_pad), 10)
        plain_ms = cuda_ms(lambda: lz4_torch.est_plain(
            lz4_torch.tokenize_plain(blocks, 2, capj, mode, dict_pad), mode), 2)
        print(f"{name} ({shape}, depth 2, capj {capj}): kernel {ms:.3f} ms "
              f"({mb / ms * 1e3:.1f} MB/s), plain {plain_ms:.3f} ms")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **tokenize_bound(blocks, got, 2, capj)}
    res["lz4_est"]["max_abs_err"] = est_err
    return res


def train_blob(cut: bytes) -> bytes:
    """A 2 KiB dictionary trained on 16 samples of 512 bytes, the recipe of
    the JAX package's ``dryrun_multichip``."""
    from zpack_tpu_torch.codecs.zstd.dict import train_dictionary

    return train_dictionary([cut[i:i + 512] for i in range(0, 8192, 512)], 2048)


def phase_dict(cut: bytes, blob: bytes, device, DeviceCompressor) -> tuple:
    """The shared-dictionary zstd path at 8 KiB blocks ("pair" mode) and at
    4 KiB blocks ("u16" mode); each frame set decodes to the cut.  Returns
    the launches and the frames of each block size."""
    from zpack_tpu_torch.codecs.zstd import frame as ZF
    from zpack_tpu_torch.utils.observe import metrics

    launches, frames = {}, {}
    mb = len(cut) / 1e6
    for B, key in ((8192, "lz4_tokenize"), (4096, "lz4_tokenize_u16")):
        dc = DeviceCompressor(device, block_size=B)
        metrics.reset()
        mark = launch_mark()
        t0 = time.perf_counter()
        comp = dc.compress_zstd(cut, 3, dictionary=blob)
        t = time.perf_counter() - t0
        run = launch_counts(mark, LZ4_KERNELS)
        print(f"dictionary path B={B} ({dc._mode(2048)} mode, {len(cut)} bytes): "
              f"{mb / t:.2f} MB/s ({t:.3f} s), ratio {len(cut) / len(comp):.4f} "
              f"({len(comp)} bytes), launches {json.dumps(run)}")
        print(f"dictionary path B={B} phases: " + json.dumps(metrics.snapshot(), sort_keys=True))
        if run[key] <= 0:
            raise AssertionError(f"dictionary path B={B} never launched {key}")
        t0 = time.perf_counter()
        out = ZF.decompress(comp, len(cut), dictionary=blob)
        if out != cut:
            raise AssertionError(
                f"dictionary path B={B}: the host decoder does not give the cut back")
        print(f"dictionary path B={B}: the host decoder with the dictionary gives the cut back "
              f"({time.perf_counter() - t0:.3f} s)")
        launches[B] = run
        frames[B] = comp
    return launches, frames


def phase_lz4_u16(corpus: bytes, device, DeviceCompressor) -> dict:
    """LZ4 ``compress`` at 8 KiB blocks ships the "u16" wire format."""
    from zpack_tpu_torch.codecs.lz4 import frame as lz4frame

    mark = launch_mark()
    t0 = time.perf_counter()
    comp = DeviceCompressor(device, block_size=8192).compress(corpus)
    t = time.perf_counter() - t0
    run = launch_counts(mark, LZ4_KERNELS)
    if run["lz4_tokenize_u16"] <= 0 or run["lz4_tokenize"]:
        raise AssertionError(f"LZ4 compress at 8 KiB blocks did not run in u16 mode: {run}")
    if lz4frame.decompress_frame(comp, len(corpus)) != corpus:
        raise AssertionError("LZ4 u16 mode: the lz4f decoder does not give the corpus back")
    print(f"LZ4 compress at 8 KiB blocks (u16 mode): {len(corpus) / 1e6 / t:.2f} MB/s "
          f"({t:.3f} s), ratio {len(corpus) / len(comp):.4f}, launches {json.dumps(run)}; "
          f"the lz4f decoder gives the corpus back")
    return run


def phase_entry(corpus: bytes, device, lz4_torch, lz4block) -> dict:
    """``entry("cuda")`` once, and ``compress_block`` on a 16 KiB sample."""
    forward, (sample,) = lz4_torch.entry(device)
    mark = launch_mark()
    src, mlen = forward(sample)
    torch.cuda.synchronize()
    want = lz4_torch.tokenize_plain(sample[None, :], 2, 16, "scatter")
    if src.shape != (16384,) or max_abs_err([src, mlen], [want[0][0], want[1][0]]):
        raise AssertionError("entry: forward(sample) disagrees with the plain version")
    raw = corpus[12345:12345 + 16384]
    comp = lz4_torch.compress_block(raw, device)
    if lz4block.decompress_block(comp, len(raw)) != raw:
        raise AssertionError("compress_block: the host block decoder does not give the sample back")
    run = launch_counts(mark, LZ4_KERNELS)
    print(f"entry: forward(sample) gives {int((mlen >= 4).sum())} match positions, equal to plain; "
          f"compress_block: {len(raw)} -> {len(comp)} bytes, decoded by the host block decoder; "
          f"launches {json.dumps(run)}")
    for k in ("lz4_tokenize_scatter", "lz4_tokenize_hash"):
        if run[k] <= 0:
            raise AssertionError(f"entry / compress_block never launched {k}")
    return run


def cli_files(corpus: bytes) -> dict:
    """The four files of the CLI phase."""
    return {"big.bin": corpus[: 16 << 20], "mid.bin": corpus[30 << 20 : (30 << 20) + 300000],
            "small.txt": corpus[:30000], "empty": b""}


def phase_cli(corpus: bytes) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        files = cli_files(corpus)
        for name, data in files.items():
            with open(os.path.join(src, name), "wb") as f:
                f.write(data)
        arch = os.path.join(tmp, "a.zpk")

        def cli(*args):
            res = subprocess.run([sys.executable, "-m", "zpack_tpu_torch", *args],
                                 cwd=ROOT, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"CLI {args[0]} failed ({res.returncode}): "
                                     f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
            return res

        res = cli("c", arch, src, "-m", "lz4:1", "--metrics")
        if "torch.dispatch" not in res.stderr:
            raise AssertionError("CLI create did not reach the device compressor")
        if "All files OK" not in cli("t", arch).stdout:
            raise AssertionError("CLI test did not report All files OK")
        out = os.path.join(tmp, "out")
        cli("x", arch, "-o", out)
        found = {}
        for dirpath, _, names in os.walk(out):
            for name in names:
                with open(os.path.join(dirpath, name), "rb") as f:
                    found[name] = f.read()
        if found != files:
            raise AssertionError("CLI extract: files differ")
        print(f"CLI: c (device), t (All files OK), x + byte compare of {len(files)} files: OK")


@contextlib.contextmanager
def codecs_on(device):
    """The codecs' device routes on ``device`` for a block, the setting put
    back afterwards."""
    from zpack_tpu_torch import codecs, engine

    setting = codecs.device_setting()
    engine.install(device)
    try:
        yield
    finally:
        codecs.set_device(setting)


def shard_launches(n_blocks: int, blocks_per_step: int, shards: int) -> int:
    """The tokenizer launches of a ``DeviceCompressor`` run: one a shard
    that holds a block, steps of ``blocks_per_step`` blocks a shard."""
    return sum(1 for step in range(0, n_blocks, blocks_per_step * shards)
               for k in range(shards) if step + k * blocks_per_step < n_blocks)


def archive_files(corpus: bytes) -> list:
    """The entries of the two-rank archive: twelve 64 KiB slices, four from
    each third of the corpus (prose, records, noise)."""
    third = len(corpus) // 3
    return [(f"part{i:02d}.bin", corpus[base + j * (1 << 20): base + j * (1 << 20) + (64 << 10)])
            for i, (base, j) in enumerate((b, j) for b in (0, third, 2 * third) for j in range(4))]


def rank_worker(argv: list) -> int:
    """One rank of the two-rank run (``chip_smoke.py --rank R WORLD PORT
    DIR``): joins the gloo group, runs ``compress_multihost`` on the cut in
    ``DIR/cut.bin`` and ``build_archive_multihost`` on the corpus slices in
    ``DIR/files.bin`` on the card, and writes both results to ``DIR``."""
    import pickle

    from zpack_tpu_torch.parallel import distributed

    from zpack_tpu_torch import engine

    rank, world, port, tmp = int(argv[0]), int(argv[1]), argv[2], argv[3]
    engine.install("cuda")
    distributed.initialize(f"127.0.0.1:{port}", world, rank)
    with open(os.path.join(tmp, "cut.bin"), "rb") as f:
        cut = f.read()
    with open(os.path.join(tmp, "files.bin"), "rb") as f:
        files = pickle.load(f)
    t0 = time.perf_counter()
    frame = distributed.compress_multihost(cut, 1, device="cuda")
    t_lz4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch = distributed.build_archive_multihost(files, level=3)
    t_arch = time.perf_counter() - t0
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"frame": frame, "archive": arch, "lz4_s": t_lz4, "archive_s": t_arch}, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def run_two_ranks(tmp: str, timeout: float = 300.0) -> list:
    """Start two ranks of :func:`rank_worker` on the card, wait for both
    (killing them on the timeout) and return their results."""
    import pickle
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "2",
                               str(port), tmp], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (1, 0)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"a rank failed ({p.returncode}): {out[-2000:]}{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def phase_mesh(corpus: bytes, cut: bytes, blob: bytes, zcomp: bytes, zstd_frame: bytes,
               dict_frame: bytes, device, card: str) -> dict:
    """Multi-device and multi-host: (a) the mesh of the visible cards and a
    mesh that names cuda:0 twice give the one-device frames (LZ4 of the
    corpus, zstd of the cut, the 8 KiB dictionary path on the cut's first 4
    MiB), the tokenizer launched once a shard a step; (b) the zstd entry
    extracted with its decode batches sharded over the mesh; (c)
    ``dryrun_multichip(2, ["cuda:0", "cuda:0"])``; (d)
    ``write_archive_parallel`` of the CLI phase's files reads back; (e) two
    processes share the card over gloo for ``compress_multihost`` and
    ``build_archive_multihost``, and agree with each other and with this
    process; (f) the elastic driver on the card with one worker crashed
    recovers the no-fault stream, and a checkpoint resume equals an
    uninterrupted run.  Two shards on one card measure the sharding's
    overhead, not a speed-up."""
    import pickle

    from zpack_tpu_torch import Reader, Writer
    from zpack_tpu_torch.codecs.zstd import frame as ZF
    from zpack_tpu_torch.parallel import archive, checkpoint, distributed, elastic, multichip
    from zpack_tpu_torch.parallel.extract import decompress_zstd_device
    from zpack_tpu_torch.parallel.pipeline import DeviceCompressor, make_mesh

    t_phase = time.perf_counter()
    meshes = {"cards": make_mesh(), "cuda:0 twice": make_mesh(["cuda:0", "cuda:0"])}
    print(f"mesh: {torch.cuda.device_count()} visible card(s); meshes "
          + ", ".join(f"{k} {m.shape} {[str(d) for d in m.devices]}" for k, m in meshes.items()))
    B = 64 << 10
    nb = -(-len(corpus) // B)
    t0 = time.perf_counter()
    one = DeviceCompressor(device).compress(corpus)
    torch.cuda.synchronize()
    times = {"lz4_s": {"one device": time.perf_counter() - t0}, "zstd_s": {}, "dict_s": {},
             "extract_s": {}}
    # zstd and dictionary runs: steps of half the blocks a shard, so that
    # two shards both tokenize
    zbps = -(-len(cut) // B) // 2
    piece = cut[: 4 << 20]
    dbps = len(piece) // 8192 // 2
    for name, mesh in meshes.items():
        dc = DeviceCompressor(mesh)
        mark = launch_mark()
        t0 = time.perf_counter()
        frame = dc.compress(corpus)
        torch.cuda.synchronize()
        times["lz4_s"][name] = time.perf_counter() - t0
        want = shard_launches(nb, dc.blocks_per_step, mesh.size)
        if frame != one:
            raise AssertionError(f"mesh {name}: the LZ4 frame differs from the one-device frame")
        got = launch_counts(mark, ["lz4_tokenize"])["lz4_tokenize"]
        if got != want:
            raise AssertionError(f"mesh {name}: {got} tokenizer launches, not {want} "
                                 f"(one a shard a step)")
        dc.blocks_per_step = zbps
        mark = launch_mark()
        t0 = time.perf_counter()
        zframe = dc.compress_zstd(cut, 3)
        times["zstd_s"][name] = time.perf_counter() - t0
        want_z = shard_launches(-(-len(cut) // B), zbps, mesh.size)
        if zframe != zstd_frame:
            raise AssertionError(f"mesh {name}: the zstd frame differs from the one-device frame")
        got = launch_counts(mark, ["lz4_tokenize"])["lz4_tokenize"]
        if got != want_z:
            raise AssertionError(f"mesh {name}: zstd launched the tokenizer {got} times, "
                                 f"not {want_z}")
        dd = DeviceCompressor(mesh, block_size=8192)
        dd.blocks_per_step = dbps
        t0 = time.perf_counter()
        dframe = dd.compress_zstd(piece, 3, dictionary=blob)
        times["dict_s"][name] = time.perf_counter() - t0
        # one frame a block: the piece's frames are the first of the cut's
        if not dict_frame.startswith(dframe) or ZF.decompress(dframe, dictionary=blob) != piece:
            raise AssertionError(f"mesh {name}: the dictionary frames differ from the one-device "
                                 f"frames")
        t0 = time.perf_counter()
        out = decompress_zstd_device(zcomp, len(corpus), device=device, mesh=mesh)
        times["extract_s"][name] = time.perf_counter() - t0
        if out != corpus:
            raise AssertionError(f"mesh {name}: the mesh extract does not give the corpus back")
        print(f"mesh {name} ({mesh.size} shard(s)): LZ4 {len(corpus)} B {times['lz4_s'][name]:.3f} s "
              f"({want} tokenizer launches), zstd {len(cut)} B {times['zstd_s'][name]:.3f} s "
              f"({want_z}), dictionary {len(piece)} B {times['dict_s'][name]:.3f} s, extract "
              f"{times['extract_s'][name]:.3f} s; frames equal the one-device frames ({card})")

    t0 = time.perf_counter()
    multichip.dryrun_multichip(2, ["cuda:0", "cuda:0"])
    times["dryrun_s"] = time.perf_counter() - t0
    print(f"mesh: dryrun_multichip(2, ['cuda:0', 'cuda:0']) passed in {times['dryrun_s']:.3f} s")

    files = list(cli_files(corpus).items())
    w = Writer.to_heap()
    w.write_header()
    w.write_data_header()
    t0 = time.perf_counter()
    archive.write_archive_parallel(w, files, meshes["cuda:0 twice"])
    times["archive_s"] = time.perf_counter() - t0
    w.write_cdr()
    w.write_eocdr()
    r = Reader.from_memory(w.buffer, shared=True)
    for name, data in files:
        if r.read_file(name) != data:
            raise AssertionError(f"write_archive_parallel: {name} does not read back")
    print(f"mesh: write_archive_parallel of {len(files)} files in {times['archive_s']:.3f} s, "
          f"every entry reads back")

    with tempfile.TemporaryDirectory() as tmp:
        ranks_files = archive_files(corpus)
        with open(os.path.join(tmp, "cut.bin"), "wb") as f:
            f.write(cut)
        with open(os.path.join(tmp, "files.bin"), "wb") as f:
            pickle.dump(ranks_files, f)
        t0 = time.perf_counter()
        ranks = run_two_ranks(tmp)
        times["two_ranks_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        frame = distributed.compress_multihost(cut, 1, device="cuda")
        times["one_rank_lz4_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arch = distributed.build_archive_multihost(ranks_files, level=3)
        times["one_rank_archive_s"] = time.perf_counter() - t0
        for key, want in (("frame", frame), ("archive", arch)):
            if ranks[0][key] != ranks[1][key] or ranks[0][key] != want:
                raise AssertionError(f"two ranks: the {key} differs between the ranks or from "
                                     f"this process's")
        times["rank_lz4_s"] = [x["lz4_s"] for x in ranks]
        times["rank_archive_s"] = [x["archive_s"] for x in ranks]
        print(f"two ranks on the card (gloo): compress_multihost {len(cut)} B "
              f"{times['rank_lz4_s']} s a rank against {times['one_rank_lz4_s']:.3f} s in one "
              f"process, build_archive_multihost {times['rank_archive_s']} s against "
              f"{times['one_rank_archive_s']:.3f} s; {times['two_ranks_s']:.3f} s with the "
              f"processes' start; both ranks equal each other and this process ({card})")

        src = os.path.join(tmp, "input.bin")
        with open(src, "wb") as f:
            f.write(cut)
        chunk = len(cut) // 8  # 2 MiB of the 16 MiB cut
        want = b"".join(elastic._compress_one(cut[i:i + chunk], "lz4", 1)
                        for i in range(0, len(cut), chunk))
        t0 = time.perf_counter()
        got = elastic.compress_file_elastic(src, os.path.join(tmp, "spool"), method="lz4",
                                            level=1, chunk_size=chunk, workers=2,
                                            worker_timeout=300.0, device="cuda",
                                            fault_args={0: ["--fail-after", "1"]})
        times["elastic_s"] = time.perf_counter() - t0
        if got != want:
            raise AssertionError("elastic: the stream after a worker crash differs from the "
                                 "no-fault chunks")
        print(f"elastic: 2 workers on cuda, worker 0 crashed after 1 chunk, "
              f"{len(cut) // chunk} chunks recovered in {times['elastic_s']:.3f} s; the stream "
              f"equals the no-fault chunks ({card})")

        spool = os.path.join(tmp, "job.spool")
        cc = checkpoint.CheckpointedCompressor(spool, method="lz4", chunk_size=chunk)
        try:
            cc.compress(cut, fail_after=3)
            raise AssertionError("checkpoint: the injected failure did not happen")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        t0 = time.perf_counter()
        resumed = cc.compress(cut)
        times["checkpoint_resume_s"] = time.perf_counter() - t0
        whole = checkpoint.CheckpointedCompressor(os.path.join(tmp, "job2.spool"), method="lz4",
                                                  chunk_size=chunk).compress(cut)
        if resumed != whole or resumed != want:
            raise AssertionError("checkpoint: the resumed stream differs from an uninterrupted run")
        print(f"checkpoint: a resume on cuda after 3 of {len(cut) // chunk} chunks "
              f"({times['checkpoint_resume_s']:.3f} s) equals an uninterrupted run")
    times["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"mesh": {"card": card, "cards": torch.cuda.device_count(), **times}}))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from zpack_tpu_torch.codecs import xxh3 as H
    from zpack_tpu_torch.codecs.lz4 import block as lz4block
    from zpack_tpu_torch.kernels import (_build, assemble_torch, fse_torch, huffman_torch,
                                         lz4_torch, xxh3_torch)
    from zpack_tpu_torch.parallel import extract
    from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc {nvcc}, driver {drv}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")

    t0 = time.perf_counter()
    corpus = build_corpus(CORPUS_BYTES)
    print(f"corpus: {len(corpus)} bytes in {time.perf_counter() - t0:.2f} s")

    tok = phase_tokenize(corpus, device, lz4_torch)
    tc = phase_tokenize_cases(device, lz4_torch)
    ser = phase_lz4_serialize(corpus, device, lz4_torch)
    ser_hc = phase_lz4_serialize_hc(corpus, device, lz4_torch)
    rep = phase_replay(corpus, device, lz4_torch, extract, DeviceCompressor, lz4block)
    lp = phase_lz4_parse(corpus, device, lz4_torch, extract, DeviceCompressor)
    sets = xxh3_sets(corpus)
    xb = phase_xxh3_batch(sets, device, xxh3_torch, H)
    xc = phase_xxh3_cases(device, xxh3_torch, H)
    xs = phase_xxh3_stream(corpus, device, xxh3_torch, H)
    x_launches = phase_xxh3_main(list(sets.values())[1], corpus, device, xxh3_torch, H)
    launches = phase_main_path(corpus, device)
    cut = zstd_cut(corpus, ZSTD_BYTES)
    rec = record_zstd_batches(cut, device, DeviceCompressor, huffman_torch, fse_torch)
    hf = phase_huffman(rec, device, huffman_torch)
    hec = phase_huffman_encode_cases(device, huffman_torch)
    fs = phase_fse(rec["fse"], device, fse_torch)
    fec = phase_fse_encode_cases(device, fse_torch)
    z_launches = phase_zstd(cut, corpus, rec["frame"], device, DeviceCompressor)
    modules = {"huffman_decode": huffman_torch, "fse_decode": fse_torch,
               "rep_totals": fse_torch, "rep_apply": fse_torch, "lz4_replay": lz4_torch,
               **dict.fromkeys(ASSEMBLY_WRITES, assemble_torch)}
    zbuf, zcomp = write_zstd_entry(corpus, device, extract)
    zk = phase_zstd_extract_kernels(zcomp, corpus, device, extract, modules)
    fc = phase_fse_cases(device, fse_torch)
    hc = phase_huffman_cases(device, huffman_torch)
    zx_launches = phase_zstd_extract_main(zbuf, zcomp, corpus, device)
    phase_zstd_corrupt_raises(zcomp, corpus, device, extract)
    zstd_frame = rec["frame"]
    del zbuf, rec
    blob = train_blob(cut)
    ep = phase_epilogues(corpus, cut, blob, device, lz4_torch)
    d_launches, d_frames = phase_dict(cut, blob, device, DeviceCompressor)
    u16_launches = phase_lz4_u16(corpus, device, DeviceCompressor)
    e_launches = phase_entry(corpus, device, lz4_torch, lz4block)
    phase_cli(corpus)
    with codecs_on(device):  # the codecs of the elastic and checkpoint references
        phase_mesh(corpus, cut, blob, zcomp, zstd_frame, d_frames[8192], device, card)
    del zcomp

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "zpack_tpu"))
    if jax_mods:
        raise AssertionError(f"modules of jax or of the JAX package were imported: {jax_mods}")
    print(f"card: {card}")
    kernels = [
        {"name": "lz4_tokenize", "route": "cuda", "source": "zpack_tpu_torch/csrc/lz4_tokenize.cu",
         "replaces": "zpack_tpu/kernels/lz4_pallas.py:106",
         "launches": launches["lz4_tokenize"], **tok,
         "max_abs_err": max(tok["max_abs_err"], ep["lz4_tokenize"]["max_abs_err"],
                            tc["lz4_tokenize"]),
         "dictionary_path_launches": d_launches[8192]["lz4_tokenize"],
         "dictionary_window_ms": ep["lz4_tokenize"]["ms"],
         "dictionary_window_plain_ms": ep["lz4_tokenize"]["plain_ms"],
         "dictionary_window_bound_ms": ep["lz4_tokenize"]["bound_ms"]},
        {"name": "lz4_tokenize_u16", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/lz4_tokenize.cu",
         "replaces": "zpack_tpu/kernels/lz4_jax.py:119",
         "launches": d_launches[4096]["lz4_tokenize_u16"], **ep["lz4_tokenize_u16"],
         "max_abs_err": max(ep["lz4_tokenize_u16"]["max_abs_err"], tc["lz4_tokenize_u16"]),
         "lz4_compress_launches": u16_launches["lz4_tokenize_u16"]},
        {"name": "lz4_tokenize_hash", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/lz4_tokenize.cu",
         "replaces": "zpack_tpu/kernels/lz4_jax.py:50",
         "launches": e_launches["lz4_tokenize_hash"], **ep["lz4_tokenize_hash"],
         "max_abs_err": max(ep["lz4_tokenize_hash"]["max_abs_err"], tc["lz4_tokenize_hash"])},
        {"name": "lz4_tokenize_scatter", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/lz4_tokenize.cu",
         "replaces": "zpack_tpu/kernels/lz4_jax.py:266",
         "launches": e_launches["lz4_tokenize_scatter"], **ep["lz4_tokenize_scatter"],
         "max_abs_err": max(ep["lz4_tokenize_scatter"]["max_abs_err"],
                            tc["lz4_tokenize_scatter"])},
        {"name": "lz4_est", "route": "cuda", "source": "zpack_tpu_torch/csrc/lz4_tokenize.cu",
         "replaces": "zpack_tpu/parallel/pipeline.py:92",
         "launches": sum(n for k, n in d_launches[4096].items() if k.startswith("lz4_tokenize")),
         **ep["lz4_est"], "max_abs_err": max(ep["lz4_est"]["max_abs_err"], tc["lz4_est"])},
        {"name": "lz4_serialize", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/lz4_serialize.cu",
         "replaces": "none: written new for the card (zpack_tpu/native.py:284, host)",
         "launches": launches["lz4_serialize"], **ser, "hc": ser_hc},
        {"name": "lz4_parse", "route": "cuda", "source": "zpack_tpu_torch/csrc/lz4_parse.cu",
         "replaces": "zpack_tpu/kernels/lz4_jax.py:433",
         "launches": launches["lz4_parse"], **lp},
        {"name": "lz4_replay", "route": "cuda", "source": "zpack_tpu_torch/csrc/lz4_replay.cu",
         "replaces": "zpack_tpu/kernels/lz4_jax.py:491",
         "launches": launches["lz4_replay"], **rep,
         "max_abs_err": max(rep["max_abs_err"], zk["lz4_replay"]["max_abs_err"]),
         "zstd_rows_launches": zx_launches["lz4_replay"],
         "zstd_rows_ms": zk["lz4_replay"]["ms"], "zstd_rows_plain_ms": zk["lz4_replay"]["plain_ms"],
         "zstd_rows_bound_ms": zk["lz4_replay"]["bound_ms"]},
        {"name": "xxh3_batch", "route": "cuda", "source": "zpack_tpu_torch/csrc/xxh3_batch.cu",
         "replaces": "zpack_tpu/kernels/xxh3_pallas.py:77",
         "launches": x_launches["xxh3_batch"], **xb, "max_abs_err": max(xb["max_abs_err"], xc)},
        {"name": "xxh3_stream", "route": "cuda", "source": "zpack_tpu_torch/csrc/xxh3_stream.cu",
         "replaces": "zpack_tpu/kernels/xxh3_jax.py:73",
         "launches": x_launches["xxh3_stream"], **xs},
        {"name": "huffman_encode", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/huffman_encode.cu",
         "replaces": "zpack_tpu/kernels/huffman_jax.py:83",
         "launches": z_launches["huffman_encode"], **hf,
         "max_abs_err": max(hf["max_abs_err"], hec)},
        {"name": "fse_encode", "route": "cuda", "source": "zpack_tpu_torch/csrc/fse_encode.cu",
         "replaces": "zpack_tpu/kernels/fse_jax.py:83",
         "launches": z_launches["fse_encode"], **fs, "max_abs_err": max(fs["max_abs_err"], fec)},
        {"name": "huffman_decode", "route": "cuda",
         "source": "zpack_tpu_torch/csrc/huffman_decode.cu",
         "replaces": "zpack_tpu/kernels/huffman_jax.py:385",
         "launches": zx_launches["huffman_decode"], **zk["huffman_decode"],
         "max_abs_err": max(zk["huffman_decode"]["max_abs_err"], hc)},
        {"name": "fse_decode", "route": "cuda", "source": "zpack_tpu_torch/csrc/fse_decode.cu",
         "replaces": "zpack_tpu/kernels/fse_jax.py:378",
         "launches": zx_launches["fse_decode"], **zk["fse_decode"],
         "max_abs_err": max(zk["fse_decode"]["max_abs_err"], fc)},
        {"name": "rep_resolve", "route": "cuda", "source": "zpack_tpu_torch/csrc/rep_resolve.cu",
         "replaces": "zpack_tpu/kernels/fse_jax.py:484",
         "launches": zx_launches["rep_totals"] + zx_launches["rep_apply"],
         "max_abs_err": max(zk["rep_totals"]["max_abs_err"], zk["rep_apply"]["max_abs_err"]),
         "ms": zk["rep_totals"]["ms"] + zk["rep_apply"]["ms"],
         "plain_ms": zk["rep_totals"]["plain_ms"] + zk["rep_apply"]["plain_ms"],
         "bound_ms": zk["rep_totals"]["bound_ms"] + zk["rep_apply"]["bound_ms"],
         "bound_by": zk["rep_totals"]["bound_by"], "library_ms": None},
        *({"name": name, "route": "cuda", "source": "zpack_tpu_torch/csrc/zstd_assemble.cu",
           "replaces": replaces, "launches": zx_launches[name], **zk[name]}
          for name, replaces in (("zstd_stitch", "zpack_tpu/parallel/extract.py:400"),
                                 ("zstd_layout", "zpack_tpu/parallel/extract.py:599"),
                                 ("zstd_trim", "zpack_tpu/parallel/extract.py:575"))),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
