"""The port's own host layers against the JAX package's, exact.

The port keeps copies of the JAX-free host modules (format, reader, writer,
stream, codecs, native loader, CLI, the checkpointed compressor, whose
source is a byte-for-byte copy).  The same seeded inputs go through both
packages: hashes, blocks, frames, dictionaries, archives, error classes and
messages, and CLI output must be identical.  Each case runs on the native
C++ engine and, with both packages' ``native.get_lib`` answering None, on the
pure-python engines."""

import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

import zpack_tpu as J
import zpack_tpu_torch as P
from test_kernels import _mix
from zpack_tpu import native as j_native
from zpack_tpu.cli import main as j_cli
from zpack_tpu.codecs import xxh3 as j_xxh3
from zpack_tpu.codecs.lz4 import block as j_block, frame as j_lz4f
from zpack_tpu.codecs.zstd import dict as j_dict, encode as j_enc, frame as j_zf
from zpack_tpu.parallel import checkpoint as j_checkpoint, host as j_host
from zpack_tpu_torch import codecs as p_codecs, engine as p_engine, native as p_native
from zpack_tpu_torch.cli import main as p_cli
from zpack_tpu_torch.codecs import xxh3 as p_xxh3
from zpack_tpu_torch.codecs.lz4 import block as p_block, frame as p_lz4f
from zpack_tpu_torch.codecs.zstd import dict as p_dict, encode as p_enc, frame as p_zf
from zpack_tpu_torch.parallel import checkpoint as p_checkpoint, host as p_host

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def host_routes():
    """The port's codecs on their host engines, as the JAX package's are
    without its engine switch; the setting is put back afterwards."""
    before = p_codecs.device_setting()
    p_engine.uninstall()
    yield
    p_codecs.set_device(before)


@pytest.fixture(params=["native", "python"])
def host_engine(request, monkeypatch):
    """Both packages on their native C++ library, or both without it."""
    if request.param == "python":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(p_native, "get_lib", lambda: None)
    else:
        assert j_native.get_lib() is not None and p_native.get_lib() is not None
    return request.param


def _data(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    return {
        "mix": lambda: _mix(n, seed=n),
        "noise": lambda: rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
        "zeros": lambda: bytes(n),
        "text": lambda: (b"the port keeps its own host layers. " * (n // 36 + 1))[:n],
    }[kind]()


def test_native_library_is_the_ports_own_build():
    assert p_native.get_lib() is not None
    assert p_native._SO.parent.name == "_build" and p_native._SO.parent.parent.name == "zpack_tpu_torch"
    assert p_native._SO.exists() and p_native._SO != j_native._SO
    # the JAX package's sources, and the zstd walk, the read layout and the
    # LZ4 HC serializer that only the port builds
    assert [s.name for s in p_native._SRCS] == \
        [s.name for s in j_native._SRCS] + ["zstd_walk.cpp", "zstd_read.cpp", "lz4_hc.cpp"]


def test_package_exports_match():
    assert P.__all__ == J.__all__
    assert P.ARCHIVE_VERSION == J.ARCHIVE_VERSION
    assert [(m.name, int(m)) for m in P.CompressionMethod] == \
        [(m.name, int(m)) for m in J.CompressionMethod]
    assert [(r.name, int(r)) for r in P.Result] == [(r.name, int(r)) for r in J.Result]


@pytest.mark.parametrize("n", [0, 1, 16, 17, 128, 129, 240, 241, 1024, 1025, 5000, 70000])
def test_xxh3_and_xxh32_and_xxh64(host_engine, n):
    data = _data("noise", n)
    assert p_xxh3.xxh3_64(data) == j_xxh3.xxh3_64(data)
    assert p_xxh3.xxh32(data, 7) == j_xxh3.xxh32(data, 7)
    assert p_xxh3.xxh64(data, 9) == j_xxh3.xxh64(data, 9)
    ps, js = p_xxh3.make_xxh3_state(), j_xxh3.make_xxh3_state()
    for lo in range(0, n, 999):
        ps.update(data[lo:lo + 999])
        js.update(data[lo:lo + 999])
    assert ps.digest() == js.digest() == j_xxh3.xxh3_64(data)


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind,n", [("mix", 0), ("mix", 12), ("mix", 70000), ("noise", 5000),
                                    ("zeros", 65536), ("text", 30000)])
def test_lz4_block(host_engine, kind, n, level):
    data = _data(kind, n)
    comp = p_block.compress_block(data, level)
    assert comp == j_block.compress_block(data, level)
    assert p_block.decompress_block(comp, n) == data == j_block.decompress_block(comp, n)
    assert p_block.compress_bound(n) == j_block.compress_bound(n)


@pytest.mark.parametrize("opts", [{}, {"block_indep": True}, {"content_checksum": True},
                                  {"block_indep": True, "content_checksum": True}],
                         ids=["linked", "indep", "linked-sum", "indep-sum"])
@pytest.mark.parametrize("kind,n", [("mix", 0), ("mix", 200000), ("noise", 70000), ("text", 150000)])
def test_lz4_frame(host_engine, kind, n, opts):
    data = _data(kind, n)
    comp = p_lz4f.compress_frame(data, 1, **opts)
    assert comp == j_lz4f.compress_frame(data, 1, **opts)
    assert p_lz4f.decompress_frame(comp, n) == data == j_lz4f.decompress_frame(comp, n)
    pd, jd = p_lz4f.FrameDecompressor(), j_lz4f.FrameDecompressor()
    assert b"".join(pd.update(comp[i:i + 777]) for i in range(0, len(comp), 777)) == data
    assert b"".join(jd.update(comp[i:i + 777]) for i in range(0, len(comp), 777)) == data
    assert pd.finished == jd.finished


@pytest.mark.parametrize("level", [1, 3, 9])
@pytest.mark.parametrize("kind,n", [("mix", 0), ("mix", 40000), ("noise", 9000), ("zeros", 50000),
                                    ("text", 30000)])
def test_zstd_encode_and_decode(host_engine, kind, n, level):
    data = _data(kind, n)
    comp = p_enc.compress(data, level)
    assert comp == j_enc.compress(data, level)
    assert p_zf.decompress(comp, n) == data == j_zf.decompress(comp, n)
    summed = p_enc.compress(data, level, checksum=True)
    assert summed == j_enc.compress(data, level, checksum=True)
    assert p_zf.decompress(summed) == data


def _samples():
    base = _mix(8192, seed=77)
    return [base[i:i + 512] for i in range(0, 8192, 512)]


@pytest.mark.parametrize("size", [1024, 2048, 16384])
def test_train_dictionary_and_dictionary_frames(host_engine, size):
    blob = p_dict.train_dictionary(_samples(), size)
    assert blob == j_dict.train_dictionary(_samples(), size)
    pz, jz = p_dict.parse_dictionary(blob), j_dict.parse_dictionary(blob)
    assert (pz.dict_id, pz.content, list(pz.rep)) == (jz.dict_id, jz.content, list(jz.rep))
    data = _mix(30000, seed=78)
    comp = p_enc.compress(data, 3, dictionary=pz)
    assert comp == j_enc.compress(data, 3, dictionary=jz)
    assert p_zf.decompress(comp, dictionary=blob) == data == j_zf.decompress(comp, dictionary=blob)
    with pytest.raises(P.errors.DecompressError) as got:
        p_zf.decompress(comp)
    with pytest.raises(J.errors.DecompressError) as want:
        j_zf.decompress(comp)
    assert str(got.value) == str(want.value)


def test_parallel_host_frames(host_engine):
    data = _mix(3 << 20, seed=79)
    for fn in ("lz4f_compress_parallel", "zstd_compress_parallel"):
        got = getattr(p_host, fn)(data, 1, chunk=1 << 20)
        assert got == getattr(j_host, fn)(data, 1, chunk=1 << 20)
    comp = j_native.zstd_compress(data, 3) or j_enc.compress(data[:100000], 3)
    assert p_host._scan_zstd_frames(comp) == j_host._scan_zstd_frames(comp)


def test_checkpoint_module_is_a_byte_for_byte_copy():
    assert pathlib.Path(p_checkpoint.__file__).read_bytes() == \
        pathlib.Path(j_checkpoint.__file__).read_bytes()


@pytest.mark.parametrize("method", ["lz4", "zstd"])
def test_checkpointed_compressor(host_engine, tmp_path, method):
    """The copy on the host engines (no device route), with a crash and a
    resume: the same stream as the JAX package's."""
    data = _mix(300000, seed=81)
    got = p_checkpoint.CheckpointedCompressor(tmp_path / "p.spool", method=method,
                                              chunk_size=64 << 10)
    with pytest.raises(RuntimeError):
        got.compress(data, fail_after=2)
    want = j_checkpoint.CheckpointedCompressor(tmp_path / "j.spool", method=method,
                                               chunk_size=64 << 10)
    assert got.compress(data) == want.compress(data)


def _entries(pkg):
    none = pkg.CompressOptions(pkg.CompressionMethod.NONE)
    lz4 = pkg.CompressOptions(pkg.CompressionMethod.LZ4, 1)
    zstd = pkg.CompressOptions(pkg.CompressionMethod.ZSTD, 3)
    return [("stored.bin", _data("noise", 5000), none),
            ("dir/text.lz4", _data("text", 90000), lz4),
            ("dir/mix.zst", _data("mix", 120000), zstd),
            ("zeros.zst", _data("zeros", 70000), zstd),
            ("empty", b"", lz4)]


def _archive(pkg) -> bytes:
    w = pkg.Writer.to_heap()
    w.write_archive(_entries(pkg))
    return bytes(w.buffer)


def test_writer_archives_are_byte_identical(host_engine):
    buf = _archive(P)
    assert buf == _archive(J)
    assert buf == P.write_archive_to_bytes(_entries(P)) == J.write_archive_to_bytes(_entries(J))
    pr, jr = P.Reader.from_memory(buf), J.Reader.from_memory(buf)
    assert [(e.filename, e.offset, e.comp_size, e.uncomp_size, e.hash, int(e.comp_method))
            for e in pr] == \
        [(e.filename, e.offset, e.comp_size, e.uncomp_size, e.hash, int(e.comp_method)) for e in jr]
    for name, data, _ in _entries(P):
        assert pr.read_file(name) == data == jr.read_file(name)
    assert pr.read_files() == jr.read_files()


def test_writer_batch_path_is_byte_identical(host_engine):
    """Eight or more small entries take the writer's batch shortcut."""
    def build(pkg):
        opt = pkg.CompressOptions(pkg.CompressionMethod.ZSTD, 3)
        lz4 = pkg.CompressOptions(pkg.CompressionMethod.LZ4, 1)
        w = pkg.Writer.to_heap()
        w.write_archive([(f"f{i:02d}", _data("mix", 3000 + 500 * i), opt if i % 2 else lz4)
                         for i in range(12)])
        return bytes(w.buffer)

    assert build(P) == build(J)


def test_streaming_reads_match(host_engine):
    buf = _archive(P)
    pr, jr = P.Reader.from_memory(buf), J.Reader.from_memory(buf)
    for name, data, _ in _entries(P):
        assert b"".join(pr.extract_iter(name, 4096)) == data == b"".join(jr.extract_iter(name, 4096))


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the class and message are what is compared
        return (type(e).__name__, str(e), int(getattr(e, "result", -1)))


@pytest.mark.parametrize("entry", ["stored.bin", "dir/text.lz4", "dir/mix.zst"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_reader_errors_on_a_corrupted_entry(host_engine, entry, where):
    """One flipped byte in an entry's data: the same exception class, message
    and result code from both Readers."""
    buf = bytearray(_archive(P))
    e = P.Reader.from_memory(bytes(buf)).get_file_entry(entry)
    pos = {"first": e.offset, "middle": e.offset + e.comp_size // 2,
           "last": e.offset + e.comp_size - 1}[where]
    buf[pos] ^= 0x5A
    bad = bytes(buf)
    got = _outcome(lambda: P.Reader.from_memory(bad).read_file(entry))
    want = _outcome(lambda: J.Reader.from_memory(bad).read_file(entry))
    assert got == want
    assert isinstance(got, tuple)


@pytest.mark.parametrize("cut", [0, 7, 100, -5, -40])
def test_reader_errors_on_a_truncated_archive(cut):
    buf = _archive(P)
    bad = buf[:cut]
    got = _outcome(lambda: P.Reader.from_memory(bad).file_count)
    assert got == _outcome(lambda: J.Reader.from_memory(bad).file_count)
    assert isinstance(got, tuple)


def _cli(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_list_and_test_output(tmp_path):
    arch = tmp_path / "a.zpk"
    arch.write_bytes(_archive(P))
    for cmd in ("l", "t"):
        got = _cli(p_cli.main, [cmd, str(arch), "--device", "cpu"])
        assert got == _cli(j_cli.main, [cmd, str(arch)])
        assert got[0] == 0 and "stored.bin" in got[1]


def test_cli_create_from_files_is_byte_identical(tmp_path):
    """``c`` with zstd entries: both packages compress them on the host
    encoder, the port's device engine installed or not."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(_data("text", 40000))
    (src / "sub" / "b.bin").write_bytes(_data("mix", 90000))
    (src / "empty").write_bytes(b"")
    outs = {}
    for name, main, extra in (("port", p_cli.main, ["--device", "cpu"]), ("jax", j_cli.main, [])):
        arch = tmp_path / f"{name}.zpk"
        rc, out = _cli(main, ["c", str(arch), str(src), "-m", "zstd:3", *extra])
        assert rc == 0
        outs[name] = (out.replace(name + ".zpk", "X.zpk"), arch.read_bytes())
    assert outs["port"] == outs["jax"]


def test_cli_errors_match(tmp_path):
    missing = str(tmp_path / "none.zpk")
    assert _cli(p_cli.main, ["l", missing, "--device", "cpu"]) == _cli(j_cli.main, ["l", missing])
    bad = tmp_path / "bad.zpk"
    bad.write_bytes(b"not an archive at all")
    assert _cli(p_cli.main, ["t", str(bad), "--device", "cpu"]) == _cli(j_cli.main, ["t", str(bad)])
    assert _cli(p_cli.main, ["q", str(bad), "--device", "cpu"])[0] == 1
