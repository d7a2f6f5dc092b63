"""The slice as a whole: archives written through the port's Writer with its
engine installed are byte-identical to the JAX package's Writer on the JAX
engine, read back through either Reader, and the port's CLI writes archives
the JAX package's CLI tests OK.  ``engine.install`` touches nothing outside
the port."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_kernels import _mix
import zpack_tpu
import zpack_tpu_torch
from zpack_tpu import codecs as jax_codecs
from zpack_tpu.cli import main as zmain
from zpack_tpu.codecs import lz4 as jax_lz4
from zpack_tpu.parallel.pipeline import MeshCompressor, make_mesh
from zpack_tpu_torch import codecs, engine
from zpack_tpu_torch.cli import main as port_cli
from zpack_tpu_torch.kernels import lz4_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entries(pkg):
    """The same entries for either package's Writer (each has its own
    ``CompressOptions`` and ``CompressionMethod``)."""
    lz4 = pkg.CompressOptions(pkg.CompressionMethod.LZ4, 1)
    zstd = pkg.CompressOptions(pkg.CompressionMethod.ZSTD, 3)
    noise = np.random.default_rng(3).integers(0, 256, 200000, dtype=np.uint8).tobytes()
    return [
        ("big.bin", _mix(1 << 20, seed=41) + noise, lz4),   # >= 64 KiB: device
        ("small.txt", _mix(30000, seed=42), lz4),           # < 64 KiB: host frame
        ("z.bin", _mix(100000, seed=43), zstd),
        ("empty", b"", lz4),
    ]


def _archive(pkg) -> bytes:
    w = pkg.Writer.to_heap()
    w.write_archive(_entries(pkg))
    return bytes(w.buffer)


@pytest.fixture(autouse=True)
def default_setting():
    """Every test starts from the registry's state at import and leaves the
    setting as it found it."""
    before = codecs.device_setting()
    codecs.set_device(codecs.DEFAULT_DEVICE)
    yield
    codecs.set_device(before)


@pytest.fixture
def port_engine():
    engine.install("cpu")


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX device engine, on one CPU device (same bytes as any mesh)."""
    monkeypatch.setenv("ZPACK_TPU_ENGINE", "tpu")
    monkeypatch.setitem(jax_lz4._MESH_COMPRESSORS, 1,
                        MeshCompressor(make_mesh(jax.devices()[:1]), level=1))
    monkeypatch.delitem(jax_codecs._INSTANCES, 2, raising=False)


def test_archive_byte_identical_to_jax_engine(jax_engine):
    want = _archive(zpack_tpu)
    engine.install("cpu")
    assert codecs.device() == torch.device("cpu")
    assert _archive(zpack_tpu_torch) == want


def test_reader_round_trips_through_the_port(port_engine, monkeypatch):
    """The port's Reader reads its own archive through the device routes (the
    big LZ4 entry through the batched replay), and so does the JAX package's
    Reader on its host engines."""
    batched = []
    real = lz4_torch.DeviceLZ4Replayer.decompress_blocks
    monkeypatch.setattr(lz4_torch.DeviceLZ4Replayer, "decompress_blocks",
                        lambda self, blocks, sizes: batched.append(len(blocks)) or real(self, blocks, sizes))
    buf = _archive(zpack_tpu_torch)
    r = zpack_tpu_torch.Reader.from_memory(buf, shared=True)
    jr = zpack_tpu.Reader.from_memory(buf, shared=True)
    for name, data, _ in _entries(zpack_tpu_torch):
        assert r.read_file(name) == data
        assert jr.read_file(name) == data
    assert batched and max(batched) >= 16


def test_install_and_uninstall_restore_the_registry(monkeypatch):
    """The setting is the port's own: no environment variable is written and
    the JAX package's registry stays as it was."""
    monkeypatch.setenv("ZPACK_TPU_ENGINE", "native")
    before = dict(codecs._REGISTRY)
    jax_before = (dict(jax_codecs._REGISTRY), dict(jax_codecs._INSTANCES))
    assert codecs.device_setting() == "cuda"
    engine.install("cpu")
    assert os.environ["ZPACK_TPU_ENGINE"] == "native"
    assert codecs.device() == torch.device("cpu")
    engine.uninstall()
    assert codecs.device() is None
    assert codecs._REGISTRY == before
    assert (dict(jax_codecs._REGISTRY), dict(jax_codecs._INSTANCES)) == jax_before
    with pytest.raises(ValueError, match="unsupported device"):
        engine.install("meta")
    assert codecs.device() is None


def test_library_defaults_to_cuda_and_raises_without_a_gpu():
    """With nothing installed the Writer, the Reader and the codecs take the
    GPU: on a machine without one they raise, and never fall to the host
    engines unasked.  ``uninstall`` is the explicit way there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lz4 = zpack_tpu_torch.CompressOptions(zpack_tpu_torch.CompressionMethod.LZ4, 1)
    data = _mix(100000, seed=46)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        codecs.device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        zpack_tpu_torch.Writer.to_heap().write_archive([("a.bin", data, lz4)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        codecs.get_codec(2).compress(data, 1)
    assert codecs.device_setting() == "cuda"
    engine.uninstall()
    w = zpack_tpu_torch.Writer.to_heap()
    w.write_archive([("a.bin", data, lz4)])
    buf = bytes(w.buffer)
    assert zpack_tpu_torch.Reader.from_memory(buf).read_file("a.bin") == data
    codecs.set_device(codecs.DEFAULT_DEVICE)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        zpack_tpu_torch.Reader.from_memory(buf).read_file("a.bin")


def test_port_cli_create_then_jax_cli_test(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(_mix(300000, seed=44))
    (src / "b.txt").write_bytes(_mix(5000, seed=45))
    (src / "empty").write_bytes(b"")
    arch = tmp_path / "a.zpk"
    res = subprocess.run(
        [sys.executable, "-m", "zpack_tpu_torch", "c", str(arch), str(src),
         "-m", "lz4:1", "--device", "cpu"],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert zmain.main(["t", str(arch)]) == 0
    assert "All files OK" in capsys.readouterr().out


def test_port_cli_refuses_cuda_without_a_gpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert port_cli.main(["l", str(tmp_path / "none.zpk"), "--device", "cuda"]) == 1
    assert "no CUDA GPU" in capsys.readouterr().err
    assert codecs.device_setting() == "cuda"


def test_trace_writes_a_chrome_trace(tmp_path):
    """``observe.trace`` wraps a region in a ``torch.profiler`` trace and
    writes it where the caller says, with each phase of the region as a
    range ``phase:<name>`` on the trace's clock."""
    import json

    from zpack_tpu_torch.utils.observe import metrics, trace

    with trace(str(tmp_path / "prof")) as dirname:
        with metrics.phase("test.tokenize", 512):
            lz4_torch.tokenize(torch.zeros((2, 256), dtype=torch.uint8))
    assert dirname == str(tmp_path / "prof")
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("sort" in e.get("name", "") for e in events)
    ranges = [e for e in events if e.get("name") == "phase:test.tokenize"]
    assert len(ranges) == 1 and ranges[0]["dur"] > 0
