"""The control of the comparison: the cell run with one of its guarantees
broken, which the comparison has to find.

The configurations state no numeric precision; they state two guarantees,
lossless and every read XXH3-verified.  The control breaks the first where
a faster or smaller archive would tempt: every entry is stored at 7 bits a
byte (the low bit cleared), the nearest precision below a byte's.  The
archive is consistent in itself (its hashes are of what it stores, so every
read verifies), and it is smaller.  Only a comparison with the bytes the
benchmark made can see it.

    python3 zbench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

runs the cell once a seed, in one process, and prints a JSON line a seed:
``correct`` and the numbers the comparison counted.  The benchmark's own
runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def install():
    """Put the 7-bit store in the program's place; returns the undo."""
    import numpy as np

    import zpack_tpu_torch as zp

    orig = zp.Writer.write_archive

    def write_archive(self, files):
        lossy = []
        for name, data, *rest in files:
            lossy.append((name, (np.frombuffer(data, np.uint8) & 0xFE).tobytes(), *rest))
        return orig(self, lossy)

    zp.Writer.write_archive = write_archive
    return lambda: setattr(zp.Writer, "write_archive", orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of the comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from zbench import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    install()
    t = T0
    for seed in args.seeds:
        result, lines = harness.run(args.workload, seed, args.seconds, False, t_start=t)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": None if result is None else result["correct"],
                          "checks": None if result is None else result["checks"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
