"""The port's zstd decode kernels on the CPU (their plain versions) against
the JAX package: the Huffman literal decode against ``DeviceHuffmanDecoder``
(scan and doubling) and ``huffman.decode_1stream``, the FSE sequence decode
against ``DeviceSequenceDecoder`` and ``seq.decode_sequences``, and the
repeat-offset resolution against ``rep_prefix_maps`` / ``apply_rep_maps`` /
``eval_rep_map``.  All integer: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from rep_cases import REP_EDGE_LENGTHS, rep_edge_case
from test_kernels import _huff_table_pair, _seq_heavy_corpora
from zpack_tpu import native
from zpack_tpu.codecs.zstd import fse as zfse, frame as zframe, huffman as H, seq as zseq
from zpack_tpu.errors import DecompressError as JaxDecompressError
from zpack_tpu.kernels import fse_jax, huffman_jax
from zpack_tpu_torch.errors import DecompressError
from zpack_tpu_torch.kernels import fse_torch, huffman_torch

torch.set_num_threads(1)


def _stream(n: int, nsym: int, alpha: float, rng) -> np.ndarray:
    return rng.choice(np.arange(nsym, dtype=np.uint8), size=n,
                      p=rng.dirichlet(np.ones(nsym) * alpha)).astype(np.uint8)


def _jax_huffman(monkeypatch, mode):
    if mode == "doubling":
        monkeypatch.setenv("ZPACK_TPU_HUFDEC", "doubling")
    else:
        monkeypatch.delenv("ZPACK_TPU_HUFDEC", raising=False)
    return huffman_jax.DeviceHuffmanDecoder()


@pytest.mark.parametrize("mode", ["scan", "doubling"])
@pytest.mark.parametrize("n", [64, 1024, 20000])
def test_huffman_one_stream_matches_jax_and_oracle(monkeypatch, n, mode):
    rng = np.random.default_rng(n + 1)
    data = _stream(n, 20, 0.5, rng)
    et, dt = _huff_table_pair(data.tobytes())
    payload = H._encode_stream(data, et)
    got = huffman_torch.TorchHuffmanDecoder("cpu").decode_batch([payload], [dt], [n])
    assert np.array_equal(got[0], data)
    assert np.array_equal(_jax_huffman(monkeypatch, mode).decode_batch([payload], [dt], [n])[0],
                          got[0])
    assert H.decode_1stream(payload, dt, n) == got[0].tobytes()


def _mixed_streams():
    """Streams over alphabets of 2 to 256 symbols, so that the tables'
    max_bits differ within one batch; with a zero-symbol stream."""
    rng = np.random.default_rng(11)
    payloads, tables, datas = [], [], []
    for nsym, n in [(4, 500), (100, 4000), (30, 1500), (2, 77), (256, 9000), (12, 1)]:
        data = _stream(n, nsym, 0.4, rng)
        data[: min(n, 2)] = [0, 1][: min(n, 2)]
        et, dt = _huff_table_pair(data.tobytes())
        if et is None:
            continue
        payloads.append(H._encode_stream(data, et))
        tables.append(dt)
        datas.append(data)
    payloads.append(payloads[0])  # a stream of zero symbols
    tables.append(tables[0])
    datas.append(np.zeros(0, np.uint8))
    return payloads, tables, datas


@pytest.mark.parametrize("mode", ["scan", "doubling"])
def test_huffman_mixed_batch_matches_jax(monkeypatch, mode):
    payloads, tables, datas = _mixed_streams()
    assert len({t.max_bits for t in tables}) >= 3
    n = [len(d) for d in datas]
    dec = huffman_torch.TorchHuffmanDecoder("cpu")
    got = dec.decode_batch(payloads, tables, n)
    assert all(np.array_equal(g, d) for g, d in zip(got, datas))
    jdec = _jax_huffman(monkeypatch, mode)
    assert all(np.array_equal(g, j) for g, j in zip(got, jdec.decode_batch(payloads, tables, n)))
    # the device-resident variant: the same final bit positions, streams
    # placed at chosen offsets with gaps between them
    size = np.array(n[::-1]) + 3  # last stream first, 3 bytes apart
    dst = (np.cumsum(size) - size)[::-1].tolist()
    syms, final = dec.decode_batch_device(payloads, tables, n, dst, n_out=int(size.sum()))
    _, jfinal = jdec.decode_batch_device(payloads, tables, n)
    assert np.array_equal(final, jfinal) and not final.any()
    flat = syms.numpy()
    assert all(np.array_equal(flat[o:o + len(d)], d) for o, d in zip(dst, datas))
    gaps = np.ones(len(flat), bool)
    for o, k in zip(dst, n):
        gaps[o:o + k] = False
    assert not flat[gaps].any()


def test_huffman_plain_contract_against_decode_streams_scan():
    """``decode_streams_plain`` on a flat batch against the JAX kernel on
    the padded batch: every symbol, and ``final`` = the position before the
    last symbol minus its bit count, over-reads included."""
    payloads, tables, datas = _mixed_streams()
    n = [len(d) + (40 if i == 1 else 0) for i, d in enumerate(datas)]  # stream 1 over-reads
    batch = huffman_torch.build_decode_batch(payloads, tables, n)
    out, final = huffman_torch.decode_streams_plain(
        *(torch.from_numpy(batch[k]) for k in huffman_torch.DECODE_ARGS), n_out=batch["n_out"])
    mb = max(t.max_bits for t in tables)
    P, n_out = 16384, 9216
    pay = np.zeros((len(payloads), P), np.uint8)
    combo = np.zeros((len(payloads), 1 << mb), np.int32)
    starts = batch["rows"][:, 2].astype(np.int32)
    for i, (p, t) in enumerate(zip(payloads, tables)):
        pay[i, :len(p)] = np.frombuffer(p, np.uint8)
        idx = np.arange(1 << mb) >> (mb - t.max_bits)
        combo[i] = t.symbols[idx].astype(np.int32) | (t.nb_bits[idx].astype(np.int32) << 8)
    sy, po, nb = (np.asarray(a) for a in huffman_jax.decode_streams_scan(
        pay, starts, combo, max_bits=mb, n_out=n_out))
    flat = out.numpy()
    off = np.cumsum(n) - n
    for i, k in enumerate(n):
        assert np.array_equal(flat[off[i]:off[i] + k], sy[i, :k])
        want = int(po[i, k - 1]) - int(nb[i, k - 1]) if k else 0
        assert int(final[i]) == want
    assert final[1] != 0 and (final[[0, 2]] == 0).all()


def test_huffman_rejects_bad_streams_as_jax_does():
    rng = np.random.default_rng(5)
    data = _stream(800, 16, 0.4, rng)
    et, dt = _huff_table_pair(data.tobytes())
    payload = H._encode_stream(data, et)
    for args, msg in (([payload], [dt], [790]), "not fully consumed"), \
                     (([payload[:-1] + b"\x00"], [dt], [800]), "missing sentinel"):
        with pytest.raises(DecompressError, match=msg):
            huffman_torch.TorchHuffmanDecoder("cpu").decode_batch(*args)
        with pytest.raises(JaxDecompressError, match=msg):
            huffman_jax.DeviceHuffmanDecoder().decode_batch(*args)


def _compressors():
    return {"zstd3": lambda b: zstandard.ZstdCompressor(level=3).compress(b),
            "zstd19": lambda b: zstandard.ZstdCompressor(level=19).compress(b),
            "native3": lambda b: native.zstd_compress(b, 3)}


def _frame_items(comp: bytes):
    """Each compressed block's sequence items, parsed by the port and by
    the JAX package, and the host oracle's decode of it; plus the table
    modes seen."""
    pos = 4
    header = zframe.parse_frame_header(comp, pos)
    pos += header.header_size
    t_port, t_jax, t_host = (zseq.SequenceTables() for _ in range(3))
    lit_state = zframe.LiteralsState()
    port, jax_items, wants, modes = [], [], [], set()
    dsd = fse_jax.DeviceSequenceDecoder()
    while True:
        bh = comp[pos] | (comp[pos + 1] << 8) | (comp[pos + 2] << 16)
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        payload = comp[pos:pos + (1 if btype == zframe.BLOCK_RLE else bsize)]
        pos += len(payload)
        if btype == zframe.BLOCK_COMPRESSED:
            _, lits_end = zframe.parse_literals_section(payload, 0, lit_state)
            want = zseq.decode_sequences(payload, lits_end, t_host)
            nb, bs = fse_torch.parse_headers(payload, lits_end, t_port)
            assert (nb, bs) == dsd.parse_headers(payload, lits_end, t_jax)
            if nb:
                _, p = zseq.parse_nb_sequences(payload, lits_end)
                modes |= {(payload[p] >> s) & 3 for s in (6, 4, 2)}
                port.append((bs, t_port.ll, t_port.of, t_port.ml, nb))
                jax_items.append((bs, t_jax.ll, t_jax.of, t_jax.ml, nb))
                wants.append(want)
        if last:
            return port, jax_items, wants, modes


@pytest.mark.parametrize("comp", list(_compressors()))
@pytest.mark.parametrize("corpus", [0, 1], ids=["words", "strided"])
def test_fse_decode_matches_jax_and_oracle(corpus, comp):
    blob = _seq_heavy_corpora()[corpus][1]
    port, jax_items, wants, _ = _frame_items(_compressors()[comp](blob))
    got = fse_torch.TorchSequenceDecoder("cpu").decode_batch(port)
    jgot = fse_jax.DeviceSequenceDecoder().decode_batch(jax_items)
    for c in range(3):
        for g, j, want in zip(got[c], jgot[c], wants):
            assert np.array_equal(g, j) and np.array_equal(g, want[c])
    assert sum(w[3] for w in wants) > 300


def test_fse_decode_saw_every_table_mode():
    """Across the frames above: predefined (0), RLE (1), compressed (2) and
    repeat (3) table modes all occur."""
    seen = set()
    for comp in _compressors().values():
        for _, blob in _seq_heavy_corpora():
            seen |= _frame_items(comp(blob))[3]
    assert seen == {0, 1, 2, 3}


def test_fse_plain_contract_against_decode_seq_streams():
    """``decode_seq_streams_plain`` against the JAX kernel on the same
    blocks, with one stream cut short (pos_f < 0), one with a byte in
    front of it (pos_f > 0) and one whose offset table holds code 31
    (err)."""
    blob = _seq_heavy_corpora()[1][1]
    items = _frame_items(native.zstd_compress(blob, 3))[0][:3]
    bs, ll, of, ml, nb = items[0]
    items += [(bs[len(bs) // 2:], ll, of, ml, nb),
              (b"\x5a" + bs, ll, of, ml, nb),
              (bs, ll, zfse.build_rle_table(31), ml, nb)]
    batch = fse_torch.build_decode_batch(items)
    lls, mls, ovs, pos_f, err = fse_torch.decode_seq_streams_plain(
        *(torch.from_numpy(batch[k]) for k in fse_torch.DECODE_ARGS))
    B = len(items)
    N = max(it[4] for it in items)
    pay = np.zeros((B, max(len(it[0]) for it in items)), np.uint8)
    tabs = np.zeros((3, B, fse_torch.TABLE), np.int32)
    for i, it in enumerate(items):
        pay[i, :len(it[0])] = np.frombuffer(it[0], np.uint8)
        for c in range(3):
            tabs[c, i] = fse_jax.pack_decode_table(it[1 + c])
    al = batch["al"].T.astype(np.int32)
    j = [np.asarray(a) for a in fse_jax.decode_seq_streams(
        pay, batch["rows"][:, 2].astype(np.int32), al[0], al[1], al[2], tabs[0], tabs[1],
        tabs[2], np.array([it[4] for it in items], np.int32), n_steps=N)]
    off = batch["seq_off"]
    for got, want in zip((lls, mls, ovs), j[:3]):
        for i, it in enumerate(items):
            assert np.array_equal(got[off[i]:off[i + 1]].numpy(), want[i, :it[4]])
    assert np.array_equal(pos_f.numpy(), j[3]) and np.array_equal(err.numpy(), j[4])
    assert pos_f[B - 3] < 0 and pos_f[B - 2] > 0 and err.tolist() == [False] * (B - 1) + [True]


def test_fse_decoder_rejects_as_jax_does():
    blob = _seq_heavy_corpora()[1][1]
    items = _frame_items(native.zstd_compress(blob, 3))[0][:2]
    bs, ll, of, ml, nb = items[1]
    for bad, msg in (((bs[:-1] + b"\x00", ll, of, ml, nb), "no sentinel"),
                     ((bs[3:], ll, of, ml, nb), "over-read"),
                     ((b"\x01" + bs, ll, of, ml, nb), "not fully consumed"),
                     ((bs, ll, zfse.build_rle_table(31), ml, nb), "offset code out of device range")):
        for dec, err in ((fse_torch.TorchSequenceDecoder("cpu"), DecompressError),
                         (fse_jax.DeviceSequenceDecoder(), JaxDecompressError)):
            with pytest.raises(err, match=msg):
                dec.decode_batch([items[0], bad])


def _host_rep(ovs, lls, rep):
    """The reference repeat-offset state machine (``execute_sequences``)."""
    offs = []
    for ov, ll in zip(ovs, lls):
        ov, ll = int(ov), int(ll)
        if ov > 3:
            offset = ov - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        elif ll != 0:
            if ov == 1:
                offset = rep[0]
            elif ov == 2:
                offset = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            if ov == 1:
                offset = rep[1]
                rep[1], rep[0] = rep[0], offset
            elif ov == 2:
                offset = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            else:
                offset = rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        offs.append(offset)
    return offs, rep


def _rep_case(seed: int, entry_base: int):
    """The random maps of ``tests/test_kernels.py``, ragged: (B, N) padded
    arrays, the counts, and the flat layout."""
    rng = np.random.default_rng(seed)
    B, N = 16, 512
    ovs = np.where(rng.random((B, N)) < 0.55, rng.integers(1, 4, (B, N)),
                   rng.integers(4, 5000, (B, N))).astype(np.int32)
    lls = np.where(rng.random((B, N)) < 0.3, 0, rng.integers(1, 50, (B, N))).astype(np.int32)
    mls = rng.integers(3, 300, (B, N)).astype(np.int32)
    nsq = rng.integers(1, N + 1, B).astype(np.int32)
    nsq[3] = 0  # an empty block
    valid = np.arange(N) < nsq[:, None]
    entry = np.tile(np.array([1, 4, 8], np.int32) + entry_base, (B, 1))
    seq_off = np.concatenate([[0], np.cumsum(nsq)]).astype(np.int64)
    flat = [torch.from_numpy(a[valid].copy()) for a in (ovs, lls, mls)]
    return ovs, lls, mls, nsq, entry, flat, torch.from_numpy(seq_off)


@pytest.mark.parametrize("entry_base", [100000, 0], ids=["no-underflow", "underflow"])
def test_rep_resolution_matches_jax_and_host(entry_base):
    ovs, lls, mls, nsq, entry, (f_ov, f_ll, f_ml), seq_off = _rep_case(7, entry_base)
    sel_p, val_p = fse_jax.rep_prefix_maps(jnp.asarray(ovs), jnp.asarray(lls), jnp.asarray(nsq))
    j_offs, j_err = (np.asarray(a) for a in fse_jax.apply_rep_maps(
        sel_p, val_p, jnp.asarray(entry), jnp.asarray(ovs), jnp.asarray(lls), jnp.asarray(nsq)))
    sel_p, val_p = np.asarray(sel_p), np.asarray(val_p)
    sel, val, sums = fse_torch.rep_totals_plain(f_ov, f_ll, f_ml, seq_off)
    offs, err = fse_torch.rep_apply_plain(f_ov, f_ll, seq_off, torch.from_numpy(entry))
    assert np.array_equal(err.numpy(), j_err)
    assert err.any() == (entry_base == 0)
    off = seq_off.numpy()
    for b in range(len(nsq)):
        k = int(nsq[b])
        assert np.array_equal(offs[off[b]:off[b + 1]].numpy(), j_offs[b, :k])
        last = max(k - 1, 0)
        assert np.array_equal(sel[b].numpy(), sel_p[b, last])
        assert np.array_equal(val[b].numpy(), val_p[b, last])
        assert sums[b].tolist() == [int(lls[b, :k].sum()), int(mls[b, :k].sum())]
        want, rep_end = _host_rep(ovs[b, :k], lls[b, :k], entry[b].tolist())
        assert offs[off[b]:off[b + 1]].tolist() == want
        assert fse_torch.eval_rep_map(sel[b], val[b], entry[b]) == rep_end
        assert fse_torch.eval_rep_map(sel[b], val[b], entry[b]) == fse_jax.eval_rep_map(
            sel_p[b, last], val_p[b, last], entry[b])


@pytest.mark.parametrize("underflow", ["none", "first", "last"])
@pytest.mark.parametrize("n", REP_EDGE_LENGTHS)
def test_rep_tile_edges_match_host_and_jax(n, underflow):
    """A block of ``n`` sequences, on both sides of the CUDA scan's warp and
    tile lengths, between two short blocks: totals, sums, offsets and the
    error flag equal the sequential state machine's and the JAX scan's."""
    lengths = [5, n, 40]
    ovs, lls, mls, seq_off, entry = rep_edge_case(lengths, underflow)
    f_ov, f_ll, f_ml = (torch.from_numpy(a) for a in (ovs, lls, mls))
    sel, val, sums = fse_torch.rep_totals_plain(f_ov, f_ll, f_ml, torch.from_numpy(seq_off))
    offs, err = fse_torch.rep_apply_plain(f_ov, f_ll, torch.from_numpy(seq_off),
                                          torch.from_numpy(entry))
    N = max(lengths)
    pad = np.zeros((2, len(lengths), N), np.int32)
    for b in range(len(lengths)):
        lo, hi = int(seq_off[b]), int(seq_off[b + 1])
        pad[0, b, : hi - lo], pad[1, b, : hi - lo] = ovs[lo:hi], lls[lo:hi]
    nsq = np.array(lengths, np.int32)
    sel_p, val_p = fse_jax.rep_prefix_maps(jnp.asarray(pad[0]), jnp.asarray(pad[1]),
                                           jnp.asarray(nsq))
    j_offs, j_err = (np.asarray(a) for a in fse_jax.apply_rep_maps(
        sel_p, val_p, jnp.asarray(entry), jnp.asarray(pad[0]), jnp.asarray(pad[1]),
        jnp.asarray(nsq)))
    sel_p, val_p = np.asarray(sel_p), np.asarray(val_p)
    assert np.array_equal(err.numpy(), j_err)
    for b, k in enumerate(lengths):
        lo, hi = int(seq_off[b]), int(seq_off[b + 1])
        want, rep_end = _host_rep(ovs[lo:hi], lls[lo:hi], entry[b].tolist())
        assert offs[lo:hi].tolist() == want
        assert np.array_equal(offs[lo:hi].numpy(), j_offs[b, :k])
        assert bool(err[b]) == any(o <= 0 for o in want)
        assert bool(err[b]) == (underflow == "first" and k >= 1 or underflow == "last" and k >= 2)
        assert fse_torch.eval_rep_map(sel[b], val[b], entry[b]) == rep_end
        last = max(k - 1, 0)
        assert np.array_equal(sel[b].numpy(), sel_p[b, last])
        assert np.array_equal(val[b].numpy(), val_p[b, last])
        assert sums[b].tolist() == [int(lls[lo:hi].sum()), int(mls[lo:hi].sum())]


def test_wrappers_reject_other_devices():
    t = torch.zeros(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        huffman_torch.decode_streams(t, t, t, n_out=1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fse_torch.decode_seq_streams(t, t, t, t, t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fse_torch.rep_totals(t, t, t, t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fse_torch.rep_apply(t, t, t, t)
