"""The port's FSE sequence-stream encoder against the JAX package's
``DeviceSequenceEncoder`` and the host oracle ``seq.encode_sequences``, on
the CPU (the plain version).  Integer bit packing: tolerance 0."""

import numpy as np
import pytest
import torch

from zpack_tpu.codecs.zstd import encode as zenc, seq as zseq
from zpack_tpu.kernels import fse_jax
from zpack_tpu_torch.kernels import fse_torch

torch.set_num_threads(1)


def _tables(lls, mls, ovs):
    ll_codes = [zseq.ll_code(int(v)) for v in lls]
    ml_codes = [zseq.ml_code(int(v)) for v in mls]
    of_codes = [int(v).bit_length() - 1 for v in ovs]
    _, ll_t, _ = zenc._pick_table(ll_codes, "ll", zseq.LL_CODE_MAX, zseq.LL_MAX_AL)
    _, of_t, _ = zenc._pick_table(of_codes, "of", zseq.OF_CODE_MAX, zseq.OF_MAX_AL)
    _, ml_t, _ = zenc._pick_table(ml_codes, "ml", zseq.ML_CODE_MAX, zseq.ML_MAX_AL)
    return ll_t, of_t, ml_t


def _random_block(rng, n, ll_hi=300, ml_hi=80, of_hi=70000):
    lls = rng.integers(0, ll_hi, n).astype(np.int64)
    mls = rng.integers(3, ml_hi, n).astype(np.int64)
    ovs = rng.integers(1, of_hi, n).astype(np.int64)
    return lls, mls, ovs


def _cases():
    """The table modes of ``tests/test_kernels.py``: nine random blocks
    (custom FSE and predefined tables, n from 1 up), an all-RLE block, an
    n = 1 block, and a skewed block whose codes stay in the predefined
    tables' range."""
    rng = np.random.default_rng(4)
    blocks = [_random_block(rng, int(rng.integers(1, 300))) for _ in range(9)]
    blocks.append((np.full(40, 5, np.int64), np.full(40, 4, np.int64), np.full(40, 1, np.int64)))
    blocks.append(_random_block(rng, 1))
    blocks.append(_random_block(rng, 500, ll_hi=8, ml_hi=12, of_hi=40))
    return blocks, [_tables(*b) for b in blocks]


def test_cases_cover_every_table_mode():
    blocks, tables = _cases()
    kinds = {type(t).__name__ for ts in tables for t in ts}
    assert kinds == {"EncodeTable", "_RleEncodeTable"}
    assert any(ts[0].al == zseq.LL_DEFAULT_AL and ts[0].counts == zseq.LL_DEFAULT_DIST
               for ts in tables if hasattr(ts[0], "counts"))


def test_encode_batch_matches_jax_and_oracle():
    blocks, tables = _cases()
    want = [zseq.encode_sequences(*b, *t) for b, t in zip(blocks, tables)]
    got = fse_torch.TorchSequenceEncoder("cpu").encode_batch(blocks, tables)
    assert got == want
    assert got == fse_jax.DeviceSequenceEncoder().encode_batch(blocks, tables)


@pytest.mark.parametrize("i", range(12))
def test_each_block_alone(i):
    blocks, tables = _cases()
    got = fse_torch.TorchSequenceEncoder("cpu").encode_batch([blocks[i]], [tables[i]])
    assert got == [zseq.encode_sequences(*blocks[i], *tables[i])]


def test_all_rle_block_packs_extra_bits_only():
    """RLE mode (al 0, all-zero rows) is a 0-bit machine: the stream holds
    the extra bits and the sentinel only."""
    lls, mls, ovs = np.full(40, 20, np.int64), np.full(40, 4, np.int64), np.full(40, 6, np.int64)
    tables = _tables(lls, mls, ovs)
    assert all(t.al == 0 for t in tables)
    batch = fse_torch.build_batch([(lls, mls, ovs)], [tables])
    words, total = fse_torch.encode_seq_streams_plain(
        *(torch.from_numpy(batch[k]) for k in fse_torch.BATCH_ARGS), n_words=batch["n_words"])
    # ll 20 has code 18 (1 extra bit), ml 4 code 1 (0 bits), ov 6 code 2 (2 bits)
    assert int(total[0]) == 40 * 3
    got = fse_torch.TorchSequenceEncoder("cpu").encode_batch([(lls, mls, ovs)], [tables])
    assert got == [zseq.encode_sequences(lls, mls, ovs, *tables)]


def test_codes_match_jax_helpers():
    rng = np.random.default_rng(12)
    lls = np.concatenate([np.arange(0, 300), rng.integers(0, 1 << 17, 500)])
    mls = np.concatenate([np.arange(3, 300), rng.integers(3, 1 << 17, 500)])
    ovs = np.concatenate([np.arange(1, 300), rng.integers(1, 1 << 30, 500)])
    assert np.array_equal(fse_torch.ll_codes_np(lls), fse_jax.ll_codes_np(lls))
    assert np.array_equal(fse_torch.ml_codes_np(mls), fse_jax.ml_codes_np(mls))
    assert np.array_equal(fse_torch.of_codes_np(ovs), fse_jax.of_codes_np(ovs))
    assert fse_torch.ll_codes_np(lls).tolist() == [zseq.ll_code(int(v)) for v in lls]
    assert fse_torch.ml_codes_np(mls).tolist() == [zseq.ml_code(int(v)) for v in mls]


def test_total_bits_within_the_header_bound():
    """Each block's words are sized by sequence_section_header's bound; the
    packed bits never reach past it."""
    blocks, tables = _cases()
    batch = fse_torch.build_batch(blocks, tables)
    _, total = fse_torch.encode_seq_streams_plain(
        *(torch.from_numpy(batch[k]) for k in fse_torch.BATCH_ARGS), n_words=batch["n_words"])
    for b, t, ub in zip(blocks, tables, batch["ub_bits"]):
        assert ub == zenc.sequence_section_header(*(x.tolist() for x in b))[2]
    assert (total.numpy() + 1 <= batch["ub_bits"]).all()


def test_empty_block_rejected():
    blocks, tables = _cases()
    z = np.zeros(0, np.int64)
    with pytest.raises(ValueError, match="at least one sequence"):
        fse_torch.TorchSequenceEncoder("cpu").encode_batch([blocks[0], (z, z, z)], tables[:2])
