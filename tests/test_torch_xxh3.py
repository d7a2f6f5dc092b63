"""The port's XXH3-64 against the JAX package's kernels and the host hash,
bit for bit (tolerance 0: this is integer hashing).

The Pallas kernel runs in interpret mode, as the JAX package's own tests
run it on the CPU; inputs stay small so the interpreter stays fast."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpack_tpu.codecs import xxh3 as H
from zpack_tpu.kernels import xxh3_jax, xxh3_pallas
from zpack_tpu_torch.kernels import xxh3_torch as X
from zpack_tpu_torch.utils.observe import launches

torch.set_num_threads(1)


def _streams(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _packed(streams):
    return X.split_packed(X.pack(streams), len(streams))


def _pallas_acc(streams):
    """``xxh3_pallas._run`` in interpret mode on the inputs laid out as
    ``xxh3_pallas.xxh3_64_batch`` lays them, as (n, 8) int64."""
    lanes, spb = xxh3_pallas.LANES, xxh3_pallas._SPB
    nstripes = np.zeros((8, lanes), dtype=np.int32)
    for k, s in enumerate(streams):
        nstripes[0, k] = (len(s) - 1) // 64
    max_blocks = max(1, -(-int(nstripes.max()) // spb))
    data = np.zeros((max_blocks, 256, lanes), dtype=np.uint32)
    for k, s in enumerate(streams):
        ns = int(nstripes[0, k])
        blocks = -(-ns // spb)
        padded = np.zeros(blocks * 256, dtype=np.uint32)
        padded[: ns * 16] = np.frombuffer(s, dtype="<u4", count=ns * 16)
        per = padded.reshape(blocks, 128, 2)
        data[:blocks, 0:128, k] = per[:, :, 0]
        data[:blocks, 128:256, k] = per[:, :, 1]
    sec_hi, sec_lo, misc = xxh3_pallas._make_consts()
    out = xxh3_pallas._run(jnp.asarray(nstripes), jnp.asarray(sec_hi), jnp.asarray(sec_lo),
                           jnp.asarray(misc), jnp.asarray(data), max_blocks, True)
    return X.acc_from_jax(out, len(streams))


_EDGES = [241, 255, 256, 257, 1024, 1025, 1088, 1089, 2049, 16385, 20000]


@pytest.mark.parametrize("streams", [
    _streams(_EDGES, 1) + [b"\xff" * 3000],
    _streams(np.random.default_rng(2).integers(241, 5001, 40), 3),
    _streams(np.random.default_rng(4).integers(241, 3001, 128), 5),
], ids=["edges", "ragged-40", "lanes-128"])
def test_accumulate_batch_plain_matches_pallas(streams):
    """Stripe counts that are and are not multiples of 16 (a scramble after
    the last whole stripe, or not), up to a full 128-lane dispatch."""
    got = X.accumulate_batch_plain(*_packed(streams))
    assert torch.equal(got, _pallas_acc(streams))


@pytest.mark.parametrize("n", [241, 1024, 1025, 65536, 200001])
def test_accumulate_stream_plain_matches_xla(n):
    buf = np.frombuffer(_streams([n], n)[0], dtype=np.uint8)
    lanes = H._KSECRET_LANES
    sec_hi = jnp.asarray((lanes >> np.uint64(32)).astype(np.uint32))
    sec_lo = jnp.asarray((lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    ns = (n - 1) // 64
    want = xxh3_jax._accumulate(jnp.asarray(buf[: ns * 64]), sec_hi, sec_lo, n)
    got = X.accumulate_stream_plain(torch.from_numpy(buf.copy()))
    assert torch.equal(got, X.acc_from_jax(want, 1)[0])


@pytest.mark.parametrize("lengths", [
    [0, 16, 240, 241] + list(np.random.default_rng(6).integers(241, 2049, 136)),
    [0, 1, 17, 129, 240],
    [241] * 3 + [2048, 0],
], ids=["over-128-long", "short-only", "few-long"])
def test_xxh3_64_batch_matches_host_and_jax(lengths):
    streams = _streams(lengths, 7)
    got = X.xxh3_64_batch(streams, device="cpu")
    assert got == [H.xxh3_64(s) for s in streams]
    assert got == xxh3_pallas.xxh3_64_batch(streams)


@pytest.mark.parametrize("n", [0, 16, 240, 241, 1024, 1025, 4103, 65536, 200001])
def test_xxh3_64_matches_xla(n):
    data = _streams([n], 100 + n)[0]
    got = X.xxh3_64(data, "cpu")
    assert got == xxh3_jax.xxh3_64_jax(data)
    assert got == H.xxh3_64(data)


def test_finish_plain_matches_host_merge():
    """The last-stripe step and ``_merge_accs`` in int64 limbs, on
    accumulators with every bit pattern class (zero, all ones, random)."""
    rng = np.random.default_rng(8)
    n = 64
    acc = rng.integers(0, 2**64, (n, 8), dtype=np.uint64)
    acc[0] = 0
    acc[1] = np.uint64(2**64 - 1)
    last = rng.integers(0, 2**64, (n, 8), dtype=np.uint64)
    last[2] = np.uint64(2**64 - 1)
    length = rng.integers(241, 2**40, n, dtype=np.int64)
    lsec = np.frombuffer(H.KSECRET, dtype="<u8", count=8,
                         offset=H.SECRET_SIZE - 64 - H._SECRET_LASTACC_START)
    want = []
    for a, d, L in zip(acc, last, length.tolist()):
        key = d ^ lsec
        a = a + (key & np.uint64(0xFFFFFFFF)) * (key >> np.uint64(32)) + d[H._SWAP_IDX]
        want.append(H._merge_accs(a, H.KSECRET, (L * H.PRIME64_1) & H.MASK64))
    got = X.finish_plain(torch.from_numpy(acc.view(np.int64)),
                         torch.from_numpy(last.view(np.int64)), torch.from_numpy(length))
    assert got.numpy().view(np.uint64).tolist() == want


def test_rows_in_place_match_host():
    """Rows may overlap and need not be packed; the wrapper's CPU path gives
    the accumulators and the hashes."""
    raw = _streams([50000], 9)[0]
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    rows = [[8, 1000], [16, 4000], [5000, 300], [96, 44000], [0, 50000], [49752, 241]]
    acc, hashes = X.accumulate_batch(flat, torch.tensor(rows, dtype=torch.int64),
                                     X.secret_tensor("cpu"))
    assert hashes.numpy().view(np.uint64).tolist() == [H.xxh3_64(raw[s:s + n]) for s, n in rows]
    assert torch.equal(acc, X.accumulate_batch_plain(*_packed([raw[s:s + n] for s, n in rows])))


def test_pack_layout():
    streams = _streams([241, 300, 1000, 17], 10)
    flat, offsets = _packed(streams)
    assert offsets.tolist() == [[0, 241], [256, 300], [560, 1000], [1568, 17]]
    assert flat.data_ptr() % 16 == 0
    for (s, n), want in zip(offsets.tolist(), streams):
        assert flat[s:s + n].numpy().tobytes() == want


def _batch_args():
    flat, offsets = _packed(_streams([300, 2000], 11))
    return flat, offsets, X.secret_tensor("cpu")


def _stream_args():
    return torch.from_numpy(np.frombuffer(_streams([3000], 12)[0], np.uint8).copy()), \
        X.secret_tensor("cpu")


@pytest.mark.parametrize("call", [
    lambda f, o, s: X.accumulate_batch(f.to(torch.int32), o, s),
    lambda f, o, s: X.accumulate_batch(f.view(-1, 2)[:, 0], o, s),
    lambda f, o, s: X.accumulate_batch(f, o.to(torch.int32), s),
    lambda f, o, s: X.accumulate_batch(f, o.t(), s),
    lambda f, o, s: X.accumulate_batch(f, o[:, :1], s),
    lambda f, o, s: X.accumulate_batch(f, o, s.flip(0)),
    lambda f, o, s: X.accumulate_batch(f, o, s.to(torch.int64)),
    lambda f, o, s: X.accumulate_batch(f, o + torch.tensor([0, -100]), s),
    lambda f, o, s: X.accumulate_batch(f, o + torch.tensor([f.numel(), 0]), s),
    lambda f, o, s: X.accumulate_batch(f, o + torch.tensor([4, 0]), s),
], ids=["flat-int32", "flat-strided", "offsets-int32", "offsets-transposed",
        "offsets-one-column", "other-secret", "secret-int64", "short-row", "row-outside",
        "row-unaligned"])
def test_accumulate_batch_rejects(call):
    with pytest.raises(ValueError):
        call(*_batch_args())


@pytest.mark.parametrize("call", [
    lambda d, s: X.accumulate_stream(d[::2], s),
    lambda d, s: X.accumulate_stream(d.to(torch.int16), s),
    lambda d, s: X.accumulate_stream(d.view(2, -1), s),
    lambda d, s: X.accumulate_stream(d[:240], s),
    lambda d, s: X.accumulate_stream(d, s[:64]),
], ids=["strided", "int16", "2-d", "short", "short-secret"])
def test_accumulate_stream_rejects(call):
    with pytest.raises(ValueError):
        call(*_stream_args())


def test_cpu_counts_no_launch():
    mark = launches()
    X.xxh3_64_batch(_streams([300, 5000], 13), "cpu")
    X.xxh3_64(_streams([5000], 14)[0], "cpu")
    run = launches(mark)
    assert {k: run[k] for k in ("xxh3_batch", "xxh3_stream")} == \
        {"xxh3_batch": 0, "xxh3_stream": 0}


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        X.xxh3_64_batch([b"x" * 300], "cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        X.xxh3_64(b"short", "cuda")
