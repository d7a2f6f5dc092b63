"""The Huffman literal decode on the adversarial batches of
``zpack_tpu_torch/kernels/huffman_cases.py``, on the CPU: the port's plain
version against the JAX package's ``huffman_jax.decode_streams_scan`` and,
where the stream is valid, the host oracle ``huffman._decode_one_stream``;
and a numpy statement of the CUDA kernel's walk (the stream staged behind
zero chunks, the table as uint16, each code read from two aligned 32-bit
words by a funnel shift) against the plain version.  All integer:
tolerance 0."""

import functools

import numpy as np
import pytest
import torch

from zpack_tpu.codecs.zstd import huffman as jhuf
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import huffman_jax
from zpack_tpu_torch.kernels import huffman_cases, huffman_torch

torch.set_num_threads(1)

CASES = huffman_cases.cases()
COLS = huffman_torch.DECODE_COLS


@functools.lru_cache(maxsize=None)
def _plain(name):
    batch = CASES[name].batch
    out, final = huffman_torch.decode_streams_plain(
        *(torch.from_numpy(batch[k]) for k in huffman_torch.DECODE_ARGS), n_out=batch["n_out"])
    return out.numpy(), final.numpy()


def _jax_rows(case, idx):
    """``decode_streams_scan`` on the rows ``idx`` of a case, padded to one
    (S, P) batch with every table widened to 11 bits: (syms, pos, nb)."""
    rows = case.batch["rows"][idx]
    P = 1 << max(6, int(rows[:, 1].max() - 1).bit_length())
    n_out = max(64, -(-int(rows[:, 3].max()) // 1024) * 1024)
    pay = np.zeros((len(idx), P), np.uint8)
    combo = np.zeros((len(idx), 1 << 11), np.int32)
    for j, i in enumerate(idx):
        payload, t, _ = case.streams[i]
        pay[j, :len(payload)] = np.frombuffer(payload, np.uint8)
        w = np.arange(1 << 11) >> (11 - t.max_bits)
        combo[j] = t.symbols[w].astype(np.int32) | (t.nb_bits[w].astype(np.int32) << 8)
    return [np.asarray(a) for a in huffman_jax.decode_streams_scan(
        pay, rows[:, 2].astype(np.int32), combo, max_bits=11, n_out=n_out)]


def _jax(case):
    """The output and ``final`` the JAX decoder gives for the case's
    well-formed rows, laid out as the port lays them out; the malformed rows
    write nothing and get -1.  Rows above 4 KiB or 4,096 symbols run alone,
    so that the padded batch stays small."""
    rows, n_out = case.batch["rows"], case.batch["n_out"]
    out, final = np.zeros(n_out, np.uint8), np.full(len(rows), -1, np.int32)
    good = [i for i, e in enumerate(case.expect) if e != "malformed"]
    big = [i for i in good if rows[i, 1] > 4096 or rows[i, 3] > 4096]
    for group in [[i for i in good if i not in big]] + [[i] for i in big]:
        if not group:
            continue
        sy, po, nb = _jax_rows(case, group)
        for j, i in enumerate(group):
            n, dst = int(rows[i, 3]), int(rows[i, 4])
            final[i] = int(po[j, n - 1]) - int(nb[j, n - 1]) if n else 0
            k = np.arange(n)
            ok = (dst + k >= 0) & (dst + k < n_out)
            out[dst + k[ok]] = sy[j, k[ok]]
    return out, final


def walk_np(batch):
    """The CUDA kernel's decode, stated in numpy and Python integers.

    Per row: the malformed rule; the bytes behind a zero chunk plus the
    row's offset in its 16-byte chunk (no offset for a row above the stage,
    read from global memory in the same layout), as 32-bit words; the table's
    first 2^max_bits entries as uint16; each step reads its code from the
    two aligned words at and above the code's lowest bit by a funnel shift.
    The kernel packs the symbols into a shared buffer that the CTA copies
    out; the bytes it stores are the ones stated here."""
    payload, rows, tables = (batch[k] for k in huffman_torch.DECODE_ARGS)
    n_out = batch["n_out"]
    smem = 16 * ((15 + min(batch["widest"], huffman_torch.STAGE_CAP) + 15) // 16 + 2)
    out, final = np.zeros(n_out, np.uint8), np.zeros(len(rows), np.int32)
    for s, (start, nbytes, p, n, dst, ti, mb) in enumerate(rows.tolist()):
        if (ti < 0 or ti >= len(tables) or not 1 <= mb <= 11 or start < 0 or nbytes < 0
                or start + nbytes > len(payload) or not 0 <= p < 8 * nbytes):
            final[s] = -1
            continue
        if n <= 0:
            continue
        mis = start % 16
        if 16 * ((mis + nbytes + 15) // 16 + 2) > smem:
            mis = 0  # global memory: the same layout from the row's first byte
        pad = 16 + mis
        stage = np.zeros(16 * ((mis + nbytes + 15) // 16 + 2), np.uint8)
        stage[pad:pad + nbytes] = payload[start:start + nbytes]
        words = stage.view("<u4").tolist()
        tab = (tables[ti, :1 << mb] & 0xFFFF).astype(np.uint16).tolist()
        q = p + 8 * pad
        for k in range(n):
            lo = q - mb
            funnel = (words[(lo >> 5) + 1] << 32 | words[lo >> 5]) >> (lo & 31)
            e = tab[funnel & ((1 << mb) - 1)]
            nb = e >> 8
            if 0 <= dst + k < n_out:
                out[dst + k] = e & 0xFF
            qb, q = q, max(q - nb, 8 * pad)
        final[s] = qb - 8 * pad - nb
    return out, final


def test_cases_cover_what_they_name():
    widths, n_syms, expect, alphabets = set(), set(), set(), set()
    shared = own = False
    for case in CASES.values():
        rows = case.batch["rows"]
        tab = [int(t) for t, e in zip(rows[:, COLS.index("table")], case.expect)
               if e != "malformed"]
        shared |= any(tab.count(t) > 1 for t in tab)
        own |= any(tab.count(t) == 1 for t in tab)
        for (_, t, n), e in zip(case.streams, case.expect):
            n_syms.add(n)
            expect.add(e)
            if e != "malformed":
                widths.add(t.max_bits)
                alphabets.add(len(np.unique(t.symbols)))
    assert widths == set(range(1, 12)) and {2, 256} <= alphabets
    assert {0, 1} <= n_syms and shared and own
    assert expect == set(huffman_cases.EXPECT)
    rows, n_out = CASES["placement"].batch["rows"], CASES["placement"].batch["n_out"]
    dst, n = rows[:, COLS.index("dst_off")], rows[:, COLS.index("n_syms")]
    assert (np.diff(dst) < 0).all() and (dst + n > n_out).any() and (dst < 0).any()
    big = CASES["above the stage cap"].batch
    assert len(big["rows"]) > 1000 and big["widest"] > huffman_torch.STAGE_CAP
    assert sorted(big["rows"][:, 1])[-2] <= huffman_torch.STAGE_CAP


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    case = CASES[name]
    out, final = _plain(name)
    want_out, want_final = _jax(case)
    assert np.array_equal(out, want_out)
    assert np.array_equal(final, want_final)
    for f, e in zip(final, case.expect):
        assert {"ok": f == 0, "empty": f == 0, "over-read": f < 0, "unconsumed": f > 0,
                "malformed": f == -1}[e], (f, e)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_host_oracle(name):
    case = CASES[name]
    out, _ = _plain(name)
    rows, n_out = case.batch["rows"], case.batch["n_out"]
    checked = 0
    for i, ((payload, t, n), e) in enumerate(zip(case.streams, case.expect)):
        if e in ("over-read", "unconsumed"):
            with pytest.raises(JaxDecompressError, match="not fully consumed"):
                jhuf._decode_one_stream(payload, t, n)
        if e not in ("ok", "empty"):
            continue
        want = jhuf._decode_one_stream(payload, t, n)
        assert np.array_equal(want, case.symbols[i][:n])
        dst = int(rows[i, COLS.index("dst_off")])
        k = np.arange(n)
        ok = (dst + k >= 0) & (dst + k < n_out)
        assert np.array_equal(out[dst + k[ok]], want[ok])
        checked += 1
    assert checked == sum(e in ("ok", "empty") for e in case.expect) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_walk_in_numpy_matches_plain(name):
    got, want = walk_np(CASES[name].batch), _plain(name)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


_EDITS = {"table past the last": ("table", "T"), "table below 0": ("table", -1),
          "max_bits 0": ("max_bits", 0), "max_bits 12": ("max_bits", 12),
          "bytes past the payload": ("n_bytes", "P"), "bytes before the payload": ("byte_start", -1),
          "start_bit at the row's end": ("start_bit", "end"), "start_bit below 0": ("start_bit", -1),
          "n_bytes below 0": ("n_bytes", -1)}


@pytest.mark.parametrize("edit", list(_EDITS))
def test_plain_malformed_row_writes_nothing_and_gets_minus_one(edit):
    """One malformed row between two valid ones: it writes nothing and gets
    final -1, its neighbours decode as before, and a start_bit at its end
    does not read the next stream's bits."""
    case = CASES["widths 1 to 11"]
    batch = {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in case.batch.items()}
    rows = batch["rows"]
    col, v = _EDITS[edit]
    v = {"T": len(batch["tables"]), "P": len(batch["payload"]), "end": 8 * rows[5, 1]}.get(v, v)
    rows[5, COLS.index(col)] = v
    args = [torch.from_numpy(batch[k]) for k in huffman_torch.DECODE_ARGS]
    assert huffman_torch.malformed(args[1], len(batch["payload"]),
                                   len(batch["tables"])).tolist() == [i == 5 for i in range(11)]
    out, final = (t.numpy() for t in huffman_torch.decode_streams_plain(*args, n_out=batch["n_out"]))
    want_out, want_final = _plain("widths 1 to 11")
    dst, n = int(rows[5, COLS.index("dst_off")]), int(rows[5, COLS.index("n_syms")])
    assert final.tolist() == [-1 if i == 5 else int(f) for i, f in enumerate(want_final)]
    assert not out[dst:dst + n].any()
    assert np.array_equal(np.delete(out, np.s_[dst:dst + n]), np.delete(want_out, np.s_[dst:dst + n]))
    got = walk_np(batch)
    assert np.array_equal(got[0], out) and np.array_equal(got[1], final)


def test_stage_size_caps_and_rejects_rows_beyond_int32_positions():
    assert huffman_torch.stage_size(0) == 0
    assert huffman_torch.stage_size(2970) == 2970
    assert huffman_torch.stage_size(10 ** 6) == huffman_torch.STAGE_CAP
    with pytest.raises(ValueError, match="int32"):
        huffman_torch.stage_size(huffman_torch.MAX_ROW_BYTES)


def test_decoder_hands_the_wrapper_the_widest_row(monkeypatch):
    """``TorchHuffmanDecoder`` passes the stage size from the host's rows,
    so the wrapper needs no read-back; the result is the same."""
    case = CASES["shared and own tables"]
    seen = []
    wrapped = huffman_torch.decode_streams

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(huffman_torch, "decode_streams", spy)
    payloads, tables, n = zip(*case.streams)
    out, final = huffman_torch.TorchHuffmanDecoder("cpu").decode_batch_device(
        list(payloads), list(tables), list(n))
    assert seen == [{"n_out": case.batch["n_out"], "widest": max(map(len, payloads))}]
    assert np.array_equal(out.numpy(), _plain("shared and own tables")[0]) and not final.any()
