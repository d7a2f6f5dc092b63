"""Sequence-section batches that stress the FSE sequence decode
(``fse_torch.decode_seq_streams``): every table mode (predefined, RLE with
accuracy log 0, compressed at the largest accuracy logs, repeat), a block of
one sequence, the over-read, unconsumed and offset-code-31 streams, blocks of
very different lengths in one batch, and a row whose bitstream is longer
than the CUDA kernel stages in shared memory (``fse_torch.STAGE_CAP``).

:func:`cases` is the one definition; the CPU tests hold
``decode_seq_streams_plain`` against the JAX decoder, the host oracle
``seq.decode_sequences`` and a numpy statement of the CUDA kernel's walk on
it, and the GPU tests and ``chip_smoke.py`` hold the kernel against
``decode_seq_streams_plain`` on the same batches.

A case is one batch: items ``(bitstream, ll, of, ml, nb_seq)`` as
``fse_torch.build_decode_batch`` takes them, the decode tables
``fse.DecodeTable``; beside each item the sequences section a block would
carry (``None`` for a corrupt stream) and what the decode must find
(:data:`EXPECT`).  Streams are written by ``seq.encode_sequences``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs.zstd import encode as zenc, fse, seq as zseq
from .fse_torch import STAGE_CAP

#: what a case's item must decode to: consumed exactly, over-read (pos_f
#: < 0), not consumed (pos_f > 0), an offset code above 30 (err), or no
#: sequence at all (its pos_f is not checked)
EXPECT = ("ok", "over-read", "unconsumed", "offset code", "empty")


class Case(NamedTuple):
    items: list
    sections: list
    expect: list


class _Side(NamedTuple):
    """One machine's table: mode, decode table, encode table, description."""
    mode: int
    dec: object
    enc: object
    desc: bytes


def _predefined(kind: str) -> _Side:
    return _Side(0, zseq.predefined_decode_table(kind), zseq.predefined_encode_table(kind), b"")


def _rle(code: int) -> _Side:
    return _Side(1, fse.build_rle_table(code), zenc._RleEncodeTable(), bytes([code]))


def _compressed(codes: np.ndarray, max_code: int, al: int) -> _Side:
    hist = np.bincount(codes, minlength=max_code + 1)
    counts = fse.normalize_counts(hist, al, len(codes))
    return _Side(2, fse.build_decode_table(counts, al), fse.build_encode_table(counts, al),
                 fse.write_ncount(counts, al))


def _repeat(side: _Side) -> _Side:
    return _Side(3, side.dec, side.enc, b"")


def _values(rng, ll_codes, of_codes, ml_codes):
    """Literal lengths, match lengths and offset values of the given codes,
    their extra bits random."""
    def extra(bits):
        return np.array([int(rng.integers(0, 1 << int(b))) if b else 0 for b in bits], np.int64)

    lls = np.array(zseq.LL_BASELINES, np.int64)[ll_codes] + extra(np.array(zseq.LL_BITS)[ll_codes])
    mls = np.array(zseq.ML_BASELINES, np.int64)[ml_codes] + extra(np.array(zseq.ML_BITS)[ml_codes])
    ovs = (np.int64(1) << of_codes.astype(np.int64)) + extra(of_codes)
    return lls, mls, ovs


def _block(rng, codes: tuple, sides: tuple) -> tuple:
    """An item and its sequences section: ``codes`` (LL, OF, ML) int arrays,
    ``sides`` their tables."""
    ll_c, of_c, ml_c = (np.asarray(c, np.int64) for c in codes)
    lls, mls, ovs = _values(rng, ll_c, of_c, ml_c)
    ll, of, ml = sides
    bs = zseq.encode_sequences(lls, mls, ovs, ll.enc, of.enc, ml.enc)
    modes = ll.mode << 6 | of.mode << 4 | ml.mode << 2
    section = (zseq.write_nb_sequences(len(ll_c)) + bytes([modes]) + ll.desc + of.desc + ml.desc
               + bs)
    return (bs, ll.dec, of.dec, ml.dec, len(ll_c)), section


def _skewed(rng, n: int, lo: int, hi: int, alpha: float = 0.3) -> np.ndarray:
    """n codes in [lo, hi] with a random skewed distribution."""
    p = rng.dirichlet(np.full(hi - lo + 1, alpha))
    return rng.choice(np.arange(lo, hi + 1), size=n, p=p)


def _wide_codes(rng, n: int) -> tuple:
    """LL, OF, ML codes over their whole alphabets (OF up to 30)."""
    return (_skewed(rng, n, 0, zseq.LL_CODE_MAX), _skewed(rng, n, 0, 30),
            _skewed(rng, n, 0, zseq.ML_CODE_MAX))


def _compressed_sides(codes: tuple) -> tuple:
    """Compressed tables at the largest accuracy logs for these codes."""
    ll_c, of_c, ml_c = codes
    return (_compressed(ll_c, zseq.LL_CODE_MAX, zseq.LL_MAX_AL),
            _compressed(of_c, zseq.OF_CODE_MAX, zseq.OF_MAX_AL),
            _compressed(ml_c, zseq.ML_CODE_MAX, zseq.ML_MAX_AL))


def _predefined_sides() -> tuple:
    return _predefined("ll"), _predefined("of"), _predefined("ml")


def _predefined_codes(rng, n: int) -> tuple:
    """Codes the predefined tables hold (OF up to 28)."""
    return (rng.integers(0, zseq.LL_CODE_MAX + 1, n), rng.integers(0, 29, n),
            rng.integers(0, zseq.ML_CODE_MAX + 1, n))


def _corrupt(item: tuple) -> dict:
    """The three corrupt streams of a valid item: cut to its upper half,
    behind one more byte, and with an offset table of code 31."""
    bs, ll, of, ml, nb = item
    return {"over-read": (bs[len(bs) // 2:], ll, of, ml, nb),
            "unconsumed": (b"\x5a" + bs, ll, of, ml, nb),
            "offset code": (bs, ll, fse.build_rle_table(31), ml, nb)}


def _case(blocks: list, expect: list | None = None) -> Case:
    """Blocks ``(item, section)`` into a case, every stream valid unless
    ``expect`` says otherwise (and then the section is None)."""
    expect = expect or ["ok"] * len(blocks)
    return Case([b[0] for b in blocks],
                [b[1] if e == "ok" else None for b, e in zip(blocks, expect)], expect)


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    # the predefined tables (accuracy logs 6, 5, 6): every code they hold
    out["predefined"] = _case([_block(rng, c, _predefined_sides())
                               for c in (_predefined_codes(rng, 400), _predefined_codes(rng, 37))])
    # RLE tables, accuracy log 0: no state bits at all, the codes with the
    # most extra bits (16, 30, 16)
    rle = (_rle(35), _rle(30), _rle(52))
    out["rle"] = _case([_block(rng, (np.full(n, 35), np.full(n, 30), np.full(n, 52)), rle)
                        for n in (300, 2)])
    # compressed at accuracy logs 9, 8, 9, then a block repeating them
    wide = _wide_codes(rng, 1500)
    sides = _compressed_sides(wide)
    again = tuple(rng.choice(c, 700) for c in wide)  # codes the tables hold
    out["compressed"] = _case([_block(rng, wide, sides)])
    out["repeat"] = _case([_block(rng, wide, sides),
                           _block(rng, again, tuple(_repeat(s) for s in sides))])
    # one sequence: no state update, in each table mode
    one = tuple(c[:1] for c in again)
    out["one sequence"] = _case([_block(rng, one, sides),
                                 _block(rng, one, tuple(_repeat(s) for s in sides)),
                                 _block(rng, (np.full(1, 35), np.full(1, 30), np.full(1, 52)), rle),
                                 _block(rng, _predefined_codes(rng, 1), _predefined_sides())])
    # the corrupt streams, beside the valid one they come from
    codes = _wide_codes(rng, 500)
    base = _block(rng, codes, _compressed_sides(codes))
    bad = _corrupt(base[0])
    out["corrupt"] = Case([base[0], *bad.values()], [base[1], None, None, None],
                          ["ok", *bad])
    # blocks of 0 to 3,000 sequences in one batch, the tables mixed
    mixed = []
    for i, n in enumerate((1, 2, 7, 33, 128, 129, 600, 3000)):
        pool = _wide_codes(rng, 400)  # the compressed tables' codes
        if i % 3 == 0:
            codes, tabs = _predefined_codes(rng, n), _predefined_sides()
        elif i % 3 == 1:
            codes, tabs = tuple(rng.choice(c, n) for c in pool), _compressed_sides(pool)
        else:  # one machine in each mode
            k = int(rng.integers(0, zseq.LL_CODE_MAX + 1))
            codes = (np.full(n, k), rng.choice(pool[1], n),
                     rng.integers(0, zseq.ML_CODE_MAX + 1, n))
            tabs = (_rle(k), _compressed_sides(pool)[1], _predefined("ml"))
        mixed.append(_block(rng, codes, tabs))
    bs, ll, of, ml, _ = mixed[3][0]
    mixed.append(((bs, ll, of, ml, 0), None))  # a row of no sequence
    out["lengths"] = _case(mixed, ["ok"] * (len(mixed) - 1) + ["empty"])
    # a row above the stage cap (14 to 16 extra bits for LL and ML, 6 state
    # bits each, 30 for the offset: about 72 bits a sequence), beside a
    # short row in the same launch
    n = 15000
    big = _block(rng, (rng.integers(33, 36, n), np.full(n, 30), rng.integers(50, 53, n)),
                 (_predefined("ll"), _rle(30), _predefined("ml")))
    if len(big[0][0]) <= STAGE_CAP:
        raise AssertionError("the row meant to exceed the stage cap does not")
    out["above the stage cap"] = _case([big, _block(rng, _predefined_codes(rng, 90),
                                                    _predefined_sides())])
    return out
