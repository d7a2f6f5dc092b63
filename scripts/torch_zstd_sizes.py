"""The zstd read's two routes by entry size, in one process on the card:
``parallel.extract.decompress_zstd_device`` (the route ``Reader.read_file``
takes with the engine installed) against ``native.zstd_decompress`` (the
host's native decoder), on entries of the desktop file tree's content
kinds (``zbench/gen/desktop.py``) from 4 KiB to 16 MiB, each compressed at
level 3 by the codec the Writer uses.

    python3 scripts/torch_zstd_sizes.py [--reads 21] [--out sizes.json]

Each (kind, size) is read ``--reads`` times by each route, the routes in
turns, after two warm reads each; a read's time is the host clock around
the call (both return bytes on the host, so the device route has finished
its work).  Prints one JSON line a (kind, size), with each route's median
ms, the device route's launches, waits and spans a read (from the
``utils/observe`` registry), then the cost of one ``metrics.count`` and one
``metrics.phase`` on this host; ``--out`` also writes them as one JSON
file.  Needs a CUDA card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SIZES = [4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20]


def _per_read(snap: dict, reads: int) -> dict:
    launches = sum(v["calls"] for k, v in snap.items() if k.startswith("launch."))
    waits = sum(v["calls"] for k, v in snap.items() if k.endswith(".wait"))
    spans = sum(v["calls"] for k, v in snap.items() if not k.startswith("launch."))
    return {"launches": launches / reads, "waits": waits / reads, "spans": spans / reads}


def _cost_ns(fn, n: int = 200_000) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t) / n * 1e9)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=21)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from zbench.gen import desktop
    from zpack_tpu_torch import native
    from zpack_tpu_torch.codecs.zstd import ZstdCodec
    from zpack_tpu_torch.parallel.extract import decompress_zstd_device
    from zpack_tpu_torch.utils.observe import metrics

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    codec = ZstdCodec()
    rows = []
    for k, content in enumerate(desktop.CONTENTS):
        for size in SIZES:
            data = desktop.generate(np.random.default_rng([k, size]), size,
                                    {"content": content}, None).tobytes()
            comp = codec.compress(data, 3)

            def dev():
                return decompress_zstd_device(comp, size, device="cuda")

            def host():
                return native.zstd_decompress(comp, size)

            for _ in range(2):
                assert dev() == data and host() == data
            metrics.reset()
            times = {"device": [], "native": []}
            for i in range(args.reads):
                for name, fn in (("device", dev), ("native", host))[::1 if i % 2 else -1]:
                    t = time.perf_counter()
                    fn()
                    times[name].append(time.perf_counter() - t)
            snap = metrics.snapshot()
            row = {"kind": content, "bytes": size, "stored_pct": round(100 * len(comp) / size, 2),
                   "device_ms": statistics.median(times["device"]) * 1e3,
                   "native_ms": statistics.median(times["native"]) * 1e3,
                   **_per_read(snap, args.reads)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    with metrics.phase("x"):
        count_ns = _cost_ns(lambda: metrics.count("launch.x"))

    def span():
        with metrics.phase("y"):
            pass

    phase_ns = _cost_ns(span)
    summary = {"card": card, "torch": torch.__version__, "count_ns": count_ns,
               "phase_ns": phase_ns}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows, **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
