"""The port stands alone: it imports nothing of jax and nothing of the JAX
package.

A subprocess puts a finder at the head of ``sys.meta_path`` that raises for
``jax``, ``jaxlib``, ``zpack_tpu`` and their submodules (not for
``zpack_tpu_torch``), imports every module of the port, and runs the LZ4 and
zstd Writer/Reader round trip (the zstd entry on the device decode, with no
fallback), the XXH3 entry points, ``compress_zstd`` with and without a
dictionary, LZ4 ``compress`` in both wire modes, and the CLI ``c``/``t`` on
``--device cpu``; afterwards no such module is in ``sys.modules``.  A source
scan holds the same for every file of the port and for ``chip_smoke.py``."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, importlib.abc, pathlib, sys, tempfile

BLOCKED = ("jax", "jaxlib", "zpack_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
for name in BLOCKED:
    try:
        importlib.import_module(name)
    except ImportError:
        continue
    raise SystemExit(f"the finder did not refuse {name}")

import numpy as np
import torch
torch.set_num_threads(1)
import zpack_tpu_torch as Z

root = pathlib.Path(Z.__file__).parent
mods = sorted(".".join(p.relative_to(root.parent).with_suffix("").parts)
              for p in root.rglob("*.py") if p.name != "__main__.py")
mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
for m in mods:
    importlib.import_module(m)
assert len(mods) >= 35, mods

from zpack_tpu_torch import engine
from zpack_tpu_torch.cli import main as cli_main
from zpack_tpu_torch.codecs import xxh3 as H, zstd as port_zstd
from zpack_tpu_torch.codecs.lz4 import frame as LF
from zpack_tpu_torch.codecs.zstd import frame as ZF
from zpack_tpu_torch.codecs.zstd.dict import train_dictionary
from zpack_tpu_torch.kernels import lz4_torch, xxh3_torch
from zpack_tpu_torch.parallel import pipeline

rng = np.random.default_rng(0)
data = (b"import-free round trip " * 6000)[:150000] + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
engine.install("cpu")
w = Z.Writer.to_heap()
w.write_archive([("d.bin", data, Z.CompressOptions(Z.CompressionMethod.LZ4, 1)),
                 ("z.bin", data, Z.CompressOptions(Z.CompressionMethod.ZSTD, 3))])
r = Z.Reader.from_memory(w.buffer, shared=True)
assert r.read_file("d.bin") == data and r.read_file("z.bin") == data
assert port_zstd.FALLBACKS == {"device_to_host": 0}
engine.uninstall()

streams = [data[:n] for n in (0, 240, 241, 5000, 70000)]
assert xxh3_torch.xxh3_64_batch(streams, "cpu") == [H.xxh3_64(s) for s in streams]
assert xxh3_torch.xxh3_64(data, "cpu") == H.xxh3_64(data)

blob = train_dictionary([data[i:i + 512] for i in range(0, 8192, 512)], 2048)
for B in (4096, 8192, 65536):
    dc = pipeline.DeviceCompressor("cpu", block_size=B)
    assert ZF.decompress(dc.compress_zstd(data, 3)) == data
    assert LF.decompress_frame(dc.compress(data)) == data
    if B <= 8192:
        assert ZF.decompress(dc.compress_zstd(data, 3, dictionary=blob), dictionary=blob) == data
mesh = pipeline.make_mesh(["cpu", "cpu"])
dc2 = pipeline.DeviceCompressor(mesh, block_size=4096)
assert dc2.compress(data) == pipeline.DeviceCompressor("cpu", block_size=4096).compress(data)
from zpack_tpu_torch.parallel import archive
engine.install("cpu")
aw = Z.Writer.to_heap()
aw.write_header()
aw.write_data_header()
archive.write_archive_parallel(aw, [("a.bin", data), ("e", b"")], mesh, block_size=4096)
aw.write_cdr()
aw.write_eocdr()
ar = Z.Reader.from_memory(aw.buffer)
assert ar.read_file("a.bin") == data and ar.read_file("e") == b""
engine.uninstall()
forward, (sample,) = lz4_torch.entry("cpu")
assert forward(sample)[0].shape == (16384,)

with tempfile.TemporaryDirectory() as tmp:
    src = pathlib.Path(tmp, "src")
    src.mkdir()
    (src / "a.bin").write_bytes(data)
    (src / "b.txt").write_bytes(data[:3000])
    arch = str(pathlib.Path(tmp, "a.zpk"))
    assert cli_main.main(["c", arch, str(src), "-m", "lz4:1", "--device", "cpu"]) == 0
    assert cli_main.main(["t", arch, "--device", "cpu"]) == 0

loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert loaded == [], loaded
print("OK")
"""


def test_port_imports_and_round_trips_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("OK")
    assert "All files OK" in res.stdout


_IMPORT = re.compile(
    r"^\s*(?:from\s+(?:jax|jaxlib|zpack_tpu)(?:\.[\w.]*)?\s+import\b"
    r"|import\s+(?:[\w.]+\s*,\s*)*(?:jax|jaxlib|zpack_tpu)(?:\.[\w.]*)?\b)"
    r"|import_module\(\s*[\"'](?:jax|jaxlib|zpack_tpu)[\"'.]"
    r"|__import__\(\s*[\"'](?:jax|jaxlib|zpack_tpu)[\"'.]", re.M)


def _port_sources() -> list[pathlib.Path]:
    return sorted((REPO / "zpack_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_pattern_finds_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import os, zpack_tpu.native",
                "    from zpack_tpu.codecs import xxh3 as H", "from zpack_tpu import native",
                "m = importlib.import_module('zpack_tpu.reader')", "__import__(\"jax\")"):
        assert _IMPORT.search(bad), bad
    for good in ("import zpack_tpu_torch", "from zpack_tpu_torch.codecs import xxh3",
                 "# mirrors zpack_tpu.kernels.lz4_jax", "from .. import native",
                 "importlib.import_module('zpack_tpu_torch.engine')"):
        assert not _IMPORT.search(good), good


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    hits = [m.group(0).strip() for m in _IMPORT.finditer(path.read_text())]
    assert hits == []
