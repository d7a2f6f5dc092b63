"""The benchmark of ``zpack_tpu_torch``: Silesia-shaped archives through the
port's ``Writer`` and ``Reader`` on an NVIDIA H100.  Run it as
``python3 zbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; ``BENCHMARK.json`` names the cells."""
