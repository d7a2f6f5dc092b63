"""The Huffman literal-stream encode on the batches of
``zpack_tpu_torch/kernels/huffman_encode_cases.py``, on the CPU: the port's
encoder (its plain version) against the JAX package's
``huffman_jax.DeviceHuffmanEncoder`` and the host oracle
``huffman._encode_stream`` / ``encode_4stream``, byte for byte; and a numpy
statement of the CUDA kernel's tile walk (a CTA of 256 threads a stream;
tiles of 16 symbols a thread counted from the 16-byte boundary below the
stream's first symbol; each field at ``bits - G``; a window of words from
the carried word down to the one that holds the tile's last field; the
window stored whole but for that lowest word, which the next tile takes)
against the plain version.  All integer: tolerance 0."""

import functools

import numpy as np
import pytest
import torch

from zpack_tpu.codecs.zstd import huffman as jhuf
from zpack_tpu.errors import CompressError as JaxCompressError
from zpack_tpu.kernels import huffman_jax
from zpack_tpu_torch.kernels import huffman_encode_cases, huffman_torch

torch.set_num_threads(1)

CASES = huffman_encode_cases.cases()
_GROUP, _MAX_LEN, _THREADS = 16, 15, 256


@functools.lru_cache(maxsize=None)
def _batch(name):
    return huffman_encode_cases.batch(CASES[name])


@functools.lru_cache(maxsize=None)
def _plain(name):
    b = _batch(name)
    words, total = huffman_torch.encode_streams_plain(
        *(torch.from_numpy(b[k]) for k in huffman_torch.BATCH_ARGS), n_words=b["n_words"])
    return words.numpy(), total.numpy()


def _port(name):
    case = CASES[name]
    enc = huffman_torch.TorchHuffmanEncoder("cpu")
    return getattr(enc, case.method)(case.items, case.tables)


def walk_np(batch):
    """The CUDA kernel's walk in numpy, a CTA a stream.  Returns ``(words,
    total_bits, writes)``: ``writes`` counts the stores of each word of the
    plane (the kernel writes every word of every stream's range once, and no
    other).  Asserts the rule by which a thread stores a word plainly: every
    word it covers but its lowest and highest holds no bit of another
    thread, of the word carried from the tile before, or of the sentinel."""
    syms, rows, tables = batch["syms"], batch["rows"], batch["tables"]
    ent = tables.view(np.uint16).astype(np.int64)
    words = np.zeros(batch["n_words"], np.int64)
    writes = np.zeros(batch["n_words"], np.int64)
    total = np.zeros(len(rows), np.int64)
    k_syms = _GROUP * _THREADS
    k_words = k_syms * _MAX_LEN // 32 + 2
    for r, (start, n, tab, bits, word) in enumerate(rows.tolist()):
        head = start % 16  # the wrapper holds syms to a 16-byte base
        n_groups = -(-(n + head) // _GROUP)
        n_tiles = max(1, -(-n_groups // _THREADS))
        top, gbase = bits >> 5, 0
        buf = np.zeros(k_words, np.int64)
        for k in range(n_tiles):
            v = k * k_syms - head + np.arange(k_syms)
            valid = (v >= 0) & (v < n)
            e = np.where(valid, ent[tab][syms[start + np.clip(v, 0, max(n - 1, 0))]] if n else 0,
                         0)
            lens = e >> 12
            codes = e & 0xFFF & ((1 << lens) - 1)
            tile_bits = int(lens.sum())
            final = k == n_tiles - 1
            lo = 0 if final else (bits - gbase - tile_bits) >> 5
            lo = min(max(lo, 0, top - k_words + 1), top)
            # each field at bits - G, G the running sum up to and including it
            p = bits - (gbase + np.cumsum(lens))
            for lw, part in ((p >> 5, (codes << (p & 31)) & 0xFFFFFFFF),
                             ((p >> 5) + 1, (codes << (p & 31)) >> 32)):
                keep = valid & (lens > 0) & (lw >= lo) & (lw <= top) & (part != 0)
                np.bitwise_or.at(buf, top - lw[keep], part[keep])
            if lo <= bits >> 5 <= top:
                buf[top - (bits >> 5)] |= 1 << (bits & 31)
            # the threads' words: lowest and highest ORed, those between stored
            tsum = lens.reshape(_THREADS, _GROUP).sum(1)
            tp = bits - (gbase + np.cumsum(tsum))
            owners = np.zeros(top - lo + 1, np.int64)
            owners[0] += k > 0  # the carried word
            if lo <= bits >> 5 <= top:
                owners[top - (bits >> 5)] += 1
            spans = [(int(q) >> 5, (int(q) + int(t) - 1) >> 5) for q, t in zip(tp, tsum) if t]
            for w_lo, w_hi in spans:
                for w in range(max(w_lo, lo), min(w_hi, top) + 1):
                    owners[top - w] += 1
            for w_lo, w_hi in spans:
                for w in range(max(w_lo + 1, lo), min(w_hi - 1, top) + 1):
                    assert owners[top - w] == 1, "a word stored plainly is shared"
            n_store = top - lo + 1 if final else top - lo
            at = word + top - np.arange(n_store)
            words[at] = buf[:n_store]
            writes[at] += 1
            carry = buf[top - lo]
            buf[:top - lo + 1] = 0
            buf[0] = carry
            top = lo
            gbase += tile_bits
        total[r] = gbase
    return words.astype(np.uint32).view(np.int32), total.astype(np.int32), writes


def test_cases_cover_what_they_name():
    tile = huffman_encode_cases.TILE
    lens, shared, once, eleven, one_bit, ends = set(), 0, 0, False, False, set()
    for case in CASES.values():
        if case.method == "encode_batch":
            lens |= {len(s) for s in case.items}
            for s, t in zip(case.items, case.tables):
                ln = t.lengths[s]
                eleven |= len(s) > 30 and bool((ln == 11).all())
                one_bit |= len(s) > 30 and bool((ln == 1).all())
                ends.add(int(ln.astype(np.int64).sum()) % 32)
        ids = [id(t) for t in case.tables]
        shared += sum(ids.count(i) > 1 for i in set(ids))
        once += sum(ids.count(i) == 1 for i in set(ids))
    assert {1, 15, 16, 17, tile - 1, tile, tile + 1} <= lens and max(lens) > 65536
    assert eleven and one_bit and {0, 1, 31} <= ends and shared and once
    four = CASES["4-stream uneven parts"]
    assert [p is None for p in huffman_encode_cases.host_payloads(four)] == \
        [False, True, False, False, False, False, True, False]
    too_long = CASES["4-stream shared tables, a part too long"]
    assert [p is None for p in huffman_encode_cases.host_payloads(too_long)] == \
        [False, False, True, False]
    assert len(CASES["tiny streams beside a long one"].items) == 301


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host_oracle(name):
    assert _port(name) == huffman_encode_cases.host_payloads(CASES[name])
    assert np.array_equal(_plain(name)[1], _batch(name)["rows"][:, 3])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    case = CASES[name]
    jax_enc = huffman_jax.DeviceHuffmanEncoder()
    assert _port(name) == getattr(jax_enc, case.method)(case.items, case.tables)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_walk_in_numpy_matches_plain(name):
    batch = _batch(name)
    words, total, writes = walk_np(batch)
    want_words, want_total = _plain(name)
    assert np.array_equal(total, want_total)
    assert np.array_equal(words, want_words)
    assert (writes == 1).all()


def test_missing_symbol_raises_in_the_4stream_batch():
    case = CASES["all 1 bit, words and tiles"]  # a two-symbol table
    blocks = [case.items[1].copy(), case.items[4].copy()]
    table = case.tables[0]
    blocks[1][40] = np.flatnonzero(table.lengths == 0)[0]
    with pytest.raises(huffman_torch.CompressError, match="misses"):
        huffman_torch.TorchHuffmanEncoder("cpu").encode_4stream_batch(blocks, [table] * 2)
    with pytest.raises(JaxCompressError):
        jhuf.encode_4stream(blocks[1].tobytes(), table)


def test_batch_lays_the_streams_back_to_back_with_the_hosts_counts():
    """The 4-stream batch splits each block as ``huffman.encode_4stream``
    does (three parts of ``ceil(n / 4)``, the rest last), one table row for
    the four; every row's ``bits`` is the oracle's count and its words
    follow the row before."""
    case = CASES["4-stream uneven parts"]
    b = _batch("4-stream uneven parts")
    start, n, tab, bits, word = b["rows"].T
    kept = [blk for blk in case.items if len(blk) - 3 * (-(-len(blk) // 4)) > 0]
    assert n.reshape(-1, 4).tolist() == [[-(-len(x) // 4)] * 3 + [len(x) - 3 * (-(-len(x) // 4))]
                                        for x in kept]
    assert (tab.reshape(-1, 4) == tab.reshape(-1, 4)[:, :1]).all()
    assert len(b["tables"]) == len(kept)
    assert np.array_equal(start, np.cumsum(n) - n) and len(b["syms"]) == n.sum()
    parts = np.split(b["syms"], np.cumsum(n)[:-1])
    tables = [t for x, t in zip(case.items, case.tables) if len(x) - 3 * (-(-len(x) // 4)) > 0]
    assert bits.tolist() == [int(tables[i // 4].lengths[p].astype(np.int64).sum())
                             for i, p in enumerate(parts)]
    size = bits // 32 + 1
    assert np.array_equal(word, np.cumsum(size) - size) and b["n_words"] == size.sum()
