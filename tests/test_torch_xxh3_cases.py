"""The many-stream XXH3 on the batches of
``zpack_tpu_torch/kernels/xxh3_cases.py``, on the CPU: the port's plain
version against the JAX package's Pallas kernel (in interpret mode, as the
JAX package's own tests run it) and the host XXH3; and a numpy statement of
the CUDA kernel's two steps (the 1 KiB block sums, then the chain a chunk of
28 blocks at a time, the partial block and the last stripe) against the
plain version, with the rows the plain version rejects yielding zeros.
Integer hashing: tolerance 0."""

import functools

import numpy as np
import pytest
import torch

from zpack_tpu.codecs import xxh3 as H
from zpack_tpu_torch.kernels import xxh3_cases, xxh3_torch as X
from test_torch_xxh3 import _pallas_acc

torch.set_num_threads(1)

CASES = xxh3_cases.cases()
_LANES = H._KSECRET_LANES.astype(np.uint64)  # (16, 8): the key of stripe j, lane i
_SWAP = np.asarray(H._SWAP_IDX)
_TAIL = np.frombuffer(H.KSECRET, "<u8", 8, H.SECRET_SIZE - 64)
_LAST = np.frombuffer(H.KSECRET, "<u8", 8, H.SECRET_SIZE - 64 - H._SECRET_LASTACC_START)
_M32 = np.uint64(0xFFFFFFFF)


def _terms(words: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Stripe terms of ``(..., 8)`` u64 words: lo32(k) * hi32(k) + the
    pair-swapped word, k = word ^ key."""
    k = words ^ keys
    return (k & _M32) * (k >> np.uint64(32)) + words[..., _SWAP]


def block_sums_np(row: np.ndarray, nblocks: int) -> np.ndarray:
    """Step 1: each 1 KiB block's sums C_b, (nblocks, 8) u64."""
    words = row[:nblocks * 1024].view("<u8").reshape(nblocks, 16, 8)
    return _terms(words, _LANES).sum(axis=1, dtype=np.uint64)


def kernel_np(case):
    """The CUDA kernel's ``(acc (n, 8), hash (n,))`` as u64, stated in numpy:
    block sums, the chain chunk by chunk, the partial block, the last stripe
    and the merge.  A rejected row yields zeros."""
    n = len(case.rows)
    acc_out = np.zeros((n, 8), np.uint64)
    hash_out = np.zeros(n, np.uint64)
    for i, ((start, length), valid) in enumerate(zip(case.rows.tolist(), case.valid)):
        if not valid:
            continue
        row = case.flat[start:start + length]
        nstripes = (length - 1) // 64
        nblocks, rem = divmod(nstripes, 16)
        sums = block_sums_np(row, nblocks)
        acc = np.array(H._INIT_ACC, np.uint64)
        for c0 in range(0, nblocks, xxh3_cases.CHUNK_BLOCKS):
            for c in sums[c0:c0 + xxh3_cases.CHUNK_BLOCKS]:
                acc = acc + c
                acc = ((acc ^ (acc >> np.uint64(47))) ^ _TAIL) * np.uint64(H.PRIME32_1)
        part = row[nblocks * 1024:nblocks * 1024 + 64 * rem].view("<u8").reshape(rem, 8)
        acc = acc + _terms(part, _LANES[:rem]).sum(axis=0, dtype=np.uint64)
        acc_out[i] = acc
        last = row[-64:].copy().view("<u8")
        final = acc + _terms(last, _LAST)
        hash_out[i] = H._merge_accs(final, H.KSECRET, (length * H.PRIME64_1) & H.MASK64)
    return acc_out, hash_out


@functools.lru_cache(maxsize=None)
def _plain(name):
    """``hash_batch_plain`` on the case's valid rows, as u64 arrays."""
    case = CASES[name]
    acc, hashes = X.hash_batch_plain(torch.from_numpy(case.flat),
                                     torch.from_numpy(case.rows[case.valid]))
    return acc.numpy().view(np.uint64), hashes.numpy().view(np.uint64)


def test_cases_cover_what_they_name():
    import chip_smoke

    assert xxh3_cases.EDGES == chip_smoke.XXH3_EDGES
    lengths = {n for c in CASES.values() for n in c.rows[c.valid, 1].tolist()}
    assert set(xxh3_cases.EDGES) <= lengths and (512 << 10) + 7 in lengths
    assert (1 << 20) in lengths and len(CASES["short rows beside 1 MiB"].rows) == 1001
    blocks = {(n - 1) // 64 // 16 for n in lengths}
    chunk = xxh3_cases.CHUNK_BLOCKS
    assert {chunk - 1, chunk, chunk + 1, 2 * chunk, 2 * chunk + 1} <= blocks
    rejected = CASES["rejected rows"]
    assert rejected.valid.tolist() == [True, False] * 6
    rows = CASES["overlapping rows in place"].rows
    assert (rows[:, 0] % 16 != 0).any() and rows[:, 1].sum() > len(CASES["overlapping rows in place"].flat)
    assert len(CASES["one row"].rows) == 1


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas(name):
    streams = xxh3_cases.streams(CASES[name])
    want = np.concatenate([_pallas_acc(streams[i:i + 128]).numpy().view(np.uint64)
                           for i in range(0, len(streams), 128)])
    assert np.array_equal(_plain(name)[0], want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host(name):
    want = [H.xxh3_64(s) for s in xxh3_cases.streams(CASES[name])]
    assert _plain(name)[1].tolist() == want


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_steps_in_numpy_match_plain(name):
    case = CASES[name]
    acc, hashes = kernel_np(case)
    want_acc, want_hash = _plain(name)
    assert np.array_equal(acc[case.valid], want_acc)
    assert np.array_equal(hashes[case.valid], want_hash)
    assert not acc[~case.valid].any() and not hashes[~case.valid].any()


def test_plain_rejects_the_rows_the_kernel_zeroes():
    case = CASES["rejected rows"]
    for row in case.rows[~case.valid]:
        rows = torch.from_numpy(np.stack([case.rows[0], row]))
        with pytest.raises(ValueError):
            X.hash_batch_plain(torch.from_numpy(case.flat), rows)
