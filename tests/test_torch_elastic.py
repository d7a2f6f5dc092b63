"""The port's elastic driver (``parallel/elastic.py``), its checkpointed
compressor (``parallel/checkpoint.py``) and its mesh dry run
(``parallel/multichip.py``) on the CPU, against the JAX package.

The five cases of ``tests/test_elastic.py`` run on the port with
``device="cpu"`` (each worker gets ``--device cpu`` and calls
``engine.install`` before it compresses): the happy path, a worker crash,
a hung worker, every worker failing, and a resume from a partial spool.
zstd output equals the JAX driver's; LZ4 output (each chunk through the
port's ``DeviceCompressor`` in the worker) equals the JAX driver's with
``ZPACK_TPU_ENGINE=tpu`` in its workers' environment.  The checkpoint
resume of ``tests/test_integration.py`` runs on the port's copy under
``engine.install("cpu")`` and equals the JAX package's output under its
engine switch.  ``dryrun_multichip(2, ["cpu", "cpu"])`` runs with steps of
one block a device."""

import functools
import json

import numpy as np
import pytest
import torch

from zpack_tpu.codecs import lz4 as jax_lz4_codec
from zpack_tpu.parallel import checkpoint as jax_checkpoint, elastic as jax_elastic
from zpack_tpu.parallel.pipeline import MeshCompressor
from zpack_tpu_torch import engine, native
from zpack_tpu_torch.codecs.lz4 import frame as LF
from zpack_tpu_torch.parallel import checkpoint, elastic, multichip
from zpack_tpu_torch.parallel.pipeline import DeviceCompressor

torch.set_num_threads(1)

CHUNK = 64 << 10


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(21)
    data = bytes(
        np.where(
            rng.random(600_000) < 0.8,
            np.tile(np.frombuffer(b"elastic recovery", dtype=np.uint8), 37500),
            rng.integers(0, 256, 600_000),
        ).astype(np.uint8)
    )
    p = tmp_path_factory.mktemp("elastic") / "input.bin"
    p.write_bytes(data)
    return p, data


@pytest.fixture(scope="module")
def jax_zstd(corpus, tmp_path_factory):
    """The JAX driver's zstd stream at 64 KiB chunks."""
    return jax_elastic.compress_file_elastic(
        corpus[0], tmp_path_factory.mktemp("jax_spool") / "spool", chunk_size=CHUNK, workers=2)


def _decode(comp: bytes, want: int) -> bytes:
    out = native.zstd_decompress(comp, want)
    assert out is not None
    return out


def test_elastic_happy_path(corpus, jax_zstd, tmp_path):
    path, data = corpus
    comp = elastic.compress_file_elastic(path, tmp_path / "spool", chunk_size=CHUNK, workers=2,
                                         device="cpu")
    assert comp == jax_zstd
    assert _decode(comp, len(data)) == data
    assert len(list((tmp_path / "spool").glob("chunk_*.bin"))) == -(-len(data) // CHUNK)


def test_elastic_worker_crash_recovers(corpus, jax_zstd, tmp_path):
    path, data = corpus
    spool = tmp_path / "spool"
    comp = elastic.compress_file_elastic(path, spool, chunk_size=CHUNK, workers=2,
                                         fault_args={0: ["--fail-after", "1"]}, device="cpu")
    assert comp == jax_zstd
    assert len(list(spool.glob("chunk_*.bin"))) == -(-len(data) // CHUNK)
    assert not list(spool.glob("*.tmp.*"))


def test_elastic_hung_worker_times_out(corpus, tmp_path):
    path, data = corpus
    comp = elastic.compress_file_elastic(
        path, tmp_path / "spool", chunk_size=128 << 10, workers=2, worker_timeout=10.0,
        fault_env={1: {"ZPACK_ELASTIC_HANG": "1"}}, device="cpu")
    assert _decode(comp, len(data)) == data


def test_elastic_all_workers_fail_raises(corpus, tmp_path):
    path, _ = corpus
    with pytest.raises(RuntimeError, match="incomplete"):
        elastic.compress_file_elastic(
            path, tmp_path / "spool", chunk_size=CHUNK, workers=2, max_rounds=1,
            fault_args={0: ["--fail-after", "0"], 1: ["--fail-after", "0"]}, device="cpu")


def test_elastic_resume_from_partial_spool(corpus, jax_zstd, tmp_path):
    path, data = corpus
    spool = tmp_path / "spool"
    spool.mkdir()
    chunk0 = elastic._compress_one(data[:CHUNK], "zstd", 3)
    elastic.chunk_path(spool, 0).write_bytes(chunk0)
    before = elastic.chunk_path(spool, 0).stat().st_mtime_ns
    comp = elastic.compress_file_elastic(path, spool, chunk_size=CHUNK, workers=2, device="cpu")
    assert elastic.chunk_path(spool, 0).stat().st_mtime_ns == before
    assert comp.startswith(chunk0) and comp == jax_zstd


def test_elastic_lz4_chunks_take_the_device_compressor(corpus, tmp_path, monkeypatch):
    """Each LZ4 chunk of 64 KiB goes through ``DeviceCompressor`` in the
    worker (torch imports there under ``-S``), so the stream equals the JAX
    driver's under its engine switch, one CPU device a JAX worker."""
    path, data = corpus
    comp = elastic.compress_file_elastic(path, tmp_path / "spool", method="lz4", level=1,
                                         chunk_size=CHUNK, workers=2,
                                         fault_args={1: ["--fail-after", "2"]}, device="cpu")
    monkeypatch.setenv("ZPACK_TPU_ENGINE", "tpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    want = jax_elastic.compress_file_elastic(path, tmp_path / "jax_spool", method="lz4", level=1,
                                             chunk_size=CHUNK, workers=2)
    assert comp == want
    assert LF.decompress_frame(comp) == data
    # every whole chunk went through the device compressor; the tail, under
    # 64 KiB, takes the host frame encoder in both packages
    whole = len(data) // CHUNK * CHUNK
    assert comp.startswith(b"".join(DeviceCompressor("cpu").compress(data[i:i + CHUNK])
                                    for i in range(0, whole, CHUNK)))


def test_elastic_worker_refuses_a_missing_gpu(corpus, tmp_path):
    """A worker told ``--device cuda`` on a machine without a GPU fails: no
    quiet CPU route."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    path, _ = corpus
    with pytest.raises(RuntimeError, match="incomplete"):
        elastic.compress_file_elastic(path, tmp_path / "spool", chunk_size=CHUNK, workers=1,
                                      max_rounds=1, device="cuda")


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_engine():
    engine.install("cpu")
    yield
    engine.uninstall()


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX codecs on their mesh route, one step of two blocks a
    device (a fresh compressor cache, so the step size takes)."""
    monkeypatch.setenv("ZPACK_TPU_ENGINE", "tpu")
    monkeypatch.setattr(jax_lz4_codec, "_MESH_COMPRESSORS", {})
    monkeypatch.setattr(MeshCompressor, "BYTES_PER_DEVICE_STEP", 2 * CHUNK)


@pytest.mark.parametrize("method", ["lz4", "zstd"])
def test_checkpoint_resume(tmp_path, cpu_engine, jax_engine, method):
    data = (b"checkpointed content block! " * 20000)[:400000]
    cc = checkpoint.CheckpointedCompressor(tmp_path / "job.spool", method=method,
                                           chunk_size=CHUNK)
    with pytest.raises(RuntimeError):
        cc.compress(data, fail_after=3)  # crash mid-job
    meta = json.loads((tmp_path / "job.spool.progress.json").read_text())
    assert len(meta["chunks"]) == 3
    comp = cc.compress(data)  # resume
    cc2 = checkpoint.CheckpointedCompressor(tmp_path / "job2.spool", method=method,
                                            chunk_size=CHUNK)
    assert cc2.compress(data) == comp
    want = jax_checkpoint.CheckpointedCompressor(tmp_path / "jax.spool", method=method,
                                                 chunk_size=CHUNK).compress(data)
    assert comp == want
    if method == "lz4":
        assert LF.decompress_frame(comp) == data
        # the first chunk went through the device compressor (the tail,
        # under 64 KiB, takes the host frame encoder in both packages)
        assert comp.startswith(DeviceCompressor("cpu").compress(data[:CHUNK]))
    else:
        assert _decode(comp, len(data)) == data
    cc3 = checkpoint.CheckpointedCompressor(tmp_path / "job.spool", method=method,
                                            chunk_size=CHUNK)
    changed = data[:-1] + b"!"
    assert cc3.compress(changed) == jax_checkpoint.CheckpointedCompressor(
        tmp_path / "jax3.spool", method=method, chunk_size=CHUNK).compress(changed)


# ---------------------------------------------------------------------------
# Dry run
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_two_cpu_shards(monkeypatch):
    monkeypatch.setattr(DeviceCompressor, "BYTES_PER_STEP", 64 << 10)
    multichip.dryrun_multichip(2, ["cpu", "cpu"])


def test_dryrun_multichip_needs_the_cards_it_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        multichip.dryrun_multichip(2)
