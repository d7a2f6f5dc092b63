"""The port never imports jax: with ``sys.modules["jax"] = None`` any jax
import raises, a Writer/Reader round trip of an LZ4 and a zstd entry
through the port still works (the zstd entry on the port's device decode,
with no fallback), and the XXH3 entry points hash and the zstd compress
path encodes on the CPU."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import zpack_tpu_torch
from zpack_tpu_torch import engine
from zpack_tpu_torch.cli import main as cli_main
from zpack_tpu_torch.kernels import _build, lz4_torch, xxh3_torch
from zpack_tpu.codecs import xxh3 as H
from zpack_tpu_torch.parallel import extract, pipeline
from zpack_tpu.constants import CompressionMethod
from zpack_tpu.reader import Reader
from zpack_tpu.writer import CompressOptions, Writer

rng = np.random.default_rng(0)
data = (b"import-free round trip " * 6000)[:150000] + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
engine.install("cpu")
w = Writer.to_heap()
w.write_archive([("d.bin", data, CompressOptions(CompressionMethod.LZ4, 1)),
                 ("z.bin", data, CompressOptions(CompressionMethod.ZSTD, 3))])
from zpack_tpu_torch.codecs import zstd as port_zstd
r = Reader.from_memory(w.buffer, shared=True)
assert r.read_file("d.bin") == data and r.read_file("z.bin") == data
assert port_zstd.FALLBACKS == {"device_to_batched": 0, "batched_to_host": 0}
engine.uninstall()
streams = [data[:n] for n in (0, 240, 241, 5000, 70000)]
assert xxh3_torch.xxh3_64_batch(streams, "cpu") == [H.xxh3_64(s) for s in streams]
assert xxh3_torch.xxh3_64(data, "cpu") == H.xxh3_64(data)
from zpack_tpu.codecs.zstd import frame as ZF
for B in (4096, 65536):
    fr = pipeline.DeviceCompressor("cpu", block_size=B).compress_zstd(data, 3)
    assert ZF.decompress(fr) == data
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m.startswith(("zpack_tpu.kernels", "zpack_tpu.parallel.pipeline",
                                 "zpack_tpu.parallel.extract")))
assert loaded == ["jax"], loaded  # only the None placeholder
print("OK")
"""


def test_port_imports_and_round_trips_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
