"""A whole run of a cell on the CPU at a small size, the look for a card
skipped, with the timed path sound and then broken underneath: the
comparison must pass the sound run and fail each fault a cell can have,
and the control (``zbench/control.py``)."""

import time

import pytest

import zpack_tpu_torch as zp
from zpack_tpu_torch import engine
from zpack_tpu_torch.codecs import get_codec

from zbench import control, harness

#: small enough for the CPU's plain decoders; the LZ4 cell keeps mozilla
#: above the device route's 64 KiB
SCALE = {"silesia-lz4.roundtrip": 0.0015, "silesia-zstd3.extract": 0.0004}


def _run(cell, seed=2**31 + 99):
    try:
        result, lines = harness.run(cell, seed, 2.0, False, t_start=time.perf_counter(),
                                    device="cpu", scale=SCALE[cell])
    finally:
        engine.uninstall()
    assert result is not None and len(lines) == len(result["checks"])
    return result


def _unchanged(orig):
    # the read hands back the stored frames: the decode's state never moved
    def read_file(self, entry, verify=True):
        return self.read_raw_file(entry)
    return read_file


def _half(orig):
    def write_archive(self, files):
        files = list(files)
        return orig(self, files[: len(files) // 2])
    return write_archive


def _altered_read(orig):
    def read_file(self, entry, verify=True):
        out = bytearray(orig(self, entry, verify))
        if out:
            out[len(out) // 2] ^= 0x20
        return bytes(out)
    return read_file


def _not_correct(cell) -> bool:
    """The run prints ``correct`` false, or none: a fault that breaks the
    set-up's own pass ends the run before its window."""
    try:
        return not _run(cell)["correct"]
    except zp.ZPackError:
        return True


FAULTS = {
    "state_unchanged": ("read_file", _unchanged),
    "half_the_batch": ("write_archive", _half),
    "answer_altered": ("read_file", _altered_read),
}


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = harness.load_cell(cell)
    assert set(result["metrics"]) == {m["name"] for m in bench.end_to_end}


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_traced_run_counts_untraced_half(cell):
    try:
        result, _ = harness.run(cell, 2**31 + 98, 3.0, True, t_start=time.perf_counter(),
                                device="cpu", scale=SCALE[cell])
    finally:
        engine.uninstall()
    assert result["correct"], result["checks"]
    bench = harness.load_cell(cell)
    assert set(result["metrics"]) <= {m["name"] for m in bench.per_layer}
    # the counters' metrics come from the untraced half, and are there
    assert result["metrics"]["archive.self_ms_per_MB.extract"]["value"] > 0
    assert "window_s" in result["device"] and "breakdown" in result


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SCALE))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    where, make = FAULTS[fault]
    cls = zp.Reader if where == "read_file" else zp.Writer
    monkeypatch.setattr(cls, where, make(getattr(cls, where)))
    assert _not_correct(cell)


def test_token_altered_in_the_codec_is_not_correct(monkeypatch):
    codec = get_codec(2)
    orig = codec.compress

    def compress(data, level=1):
        out = bytearray(orig(data, level))
        out[len(out) // 2] ^= 0x08
        return bytes(out)

    monkeypatch.setattr(codec, "compress", compress)
    assert _not_correct("silesia-lz4.roundtrip")


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_control_is_not_correct(cell):
    undo = control.install()
    try:
        result = _run(cell)
    finally:
        undo()
    assert not result["correct"]
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["archive_faults"] > 0 and checks["read_faults"] > 0
