"""The benchmark's own CPU tests: ``python -m pytest zbench/tests`` from the
root of the repository.  They import the harness as the package
``zbench`` and run the port's device routes on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the workers of a parallel test run would otherwise each start a thread a
# core for the CPU routes' tensor ops, and starve each other
torch.set_num_threads(1)
