"""Sequence batches that stress the FSE sequence encode
(``fse_torch.encode_seq_streams``): every table mode (predefined, RLE,
compressed at the largest accuracy logs, repeat), blocks of one and two
sequences, offset codes up to 31 and literal and match lengths with 16
extra bits, a block longer than the CUDA kernel stages in shared memory
(``fse_torch.ENCODE_STAGE_CAP``), many tiny blocks beside a long one, blocks
at the edges of the kernel's packing tiles (256 sequences), and blocks whose
bits end on a word.

:func:`cases` is the one definition; the CPU tests hold
``encode_seq_streams_plain`` against the JAX encoder, the host oracle
``seq.encode_sequences`` and a numpy statement of the CUDA kernel's two steps
on it, and the GPU tests and ``chip_smoke.py`` hold the kernel against
``encode_seq_streams_plain`` on the same batches.

A case is one batch as ``fse_torch.TorchSequenceEncoder.encode_batch``
takes it: per block ``(lls, mls, ovs)`` int64 arrays in sequence order and
the ``(ll, of, ml)`` encode tables.  ``fits_jax`` is False for the one case
whose blocks write more bits than the JAX encoder's word buffer holds (about
64 bits a sequence, ``fse_jax.DeviceSequenceEncoder``): the JAX words drop
the overflow there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codecs.zstd import seq as zseq
from .fse_cases import _compressed, _predefined, _rle, _skewed, _values
from .fse_torch import ENCODE_STAGE_CAP

#: sequences a packing tile of the CUDA kernel holds (its CTA size)
TILE = 256


class Case(NamedTuple):
    blocks: list
    tables: list
    fits_jax: bool = True


def _block(rng, codes: tuple, sides: tuple) -> tuple:
    """A block of the given (LL, OF, ML) codes, extra bits random, and its
    encode tables."""
    ll_c, of_c, ml_c = (np.asarray(c, np.int64) for c in codes)
    lls, mls, ovs = _values(rng, ll_c, of_c, ml_c)
    return (lls, mls, ovs), tuple(s.enc for s in sides)


def _case(blocks: list, fits_jax: bool = True) -> Case:
    return Case([b[0] for b in blocks], [b[1] for b in blocks], fits_jax)


def _predefined_sides() -> tuple:
    return _predefined("ll"), _predefined("of"), _predefined("ml")


def _predefined_codes(rng, n: int) -> tuple:
    """Codes the predefined tables hold (OF up to 28)."""
    return (rng.integers(0, zseq.LL_CODE_MAX + 1, n), rng.integers(0, 29, n),
            rng.integers(0, zseq.ML_CODE_MAX + 1, n))


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


def total_bits(block: tuple, tables: tuple) -> int:
    """A block's bits without the sentinel, from the host encoder's bytes."""
    bs = zseq.encode_sequences(*block, *tables)
    return 8 * (len(bs) - 1) + bs[-1].bit_length() - 1


def _ending_on(rng, residue: int, n: int) -> tuple:
    """A predefined-table block of n sequences whose bits (sentinel
    excluded) are ``residue`` mod 32."""
    while True:
        b = _block(rng, _predefined_codes(rng, n), _predefined_sides())
        if total_bits(*b) % 32 == residue:
            return b


def cases(seed: int = 0) -> dict:
    """name -> :class:`Case`.  Each case names what it is hard for."""
    rng = np.random.default_rng(seed)
    out = {}
    # the predefined tables (accuracy logs 6, 5, 6): every code they hold
    out["predefined"] = _case([_block(rng, _predefined_codes(rng, n), _predefined_sides())
                               for n in (400, 37)])
    # RLE, a 0-bit machine: no state bits, the codes with the most extra
    # bits (ll and ml 16, of 30)
    rle = (_rle(35), _rle(30), _rle(52))
    out["rle"] = _case([_block(rng, (np.full(n, 35), np.full(n, 30), np.full(n, 52)), rle)
                        for n in (300, 2)])
    # compressed at accuracy logs 9, 8, 9, then a block repeating them
    wide = _wide_codes(rng, 1500)
    sides = _compressed_sides(wide)
    again = tuple(rng.choice(c, 700) for c in wide)  # codes the tables hold
    out["compressed"] = _case([_block(rng, wide, sides)])
    # (repeat mode encodes with the previous block's tables as they are)
    out["repeat"] = _case([_block(rng, wide, sides), _block(rng, again, sides)])
    # one and two sequences: no state update, or one, in every mode
    blocks = []
    for n in (1, 2):
        blocks += [_block(rng, tuple(c[:n] for c in again), sides),
                   _block(rng, (np.full(n, 35), np.full(n, 30), np.full(n, 52)), rle),
                   _block(rng, _predefined_codes(rng, n), _predefined_sides())]
    out["one and two sequences"] = _case(blocks)
    # offset code 31 (an offset extra of 31 bits from an int32 field) beside
    # literal and match lengths of 16 extra bits: RLE machines, and a
    # compressed offset table with 31 in one code of eight
    of31 = np.where(rng.random(900) < 0.125, 31, rng.integers(0, 20, 900))
    wide31 = (_skewed(rng, 900, 30, zseq.LL_CODE_MAX), of31,
              _skewed(rng, 900, 48, zseq.ML_CODE_MAX))
    out["wide fields"] = _case([
        _block(rng, (np.full(200, 35), np.full(200, 31), np.full(200, 52)),
               (_rle(35), _rle(31), _rle(52))),
        _block(rng, wide31, _compressed_sides(wide31))])
    # every sequence at the widest extras (63 bits) under compressed tables
    # spread over whole alphabets (about 5 state bits a machine): about 78
    # bits a sequence, more than the JAX encoder's buffer of 64 a sequence
    # (its smallest bucket is 64 sequences)
    n = 64
    spread = (np.arange(zseq.LL_CODE_MAX + 1), np.arange(zseq.OF_CODE_MAX + 1),
              np.arange(zseq.ML_CODE_MAX + 1))
    out["beyond the JAX word buffer"] = _case(
        [_block(rng, (np.full(n, 35), np.full(n, 31), np.full(n, 52)),
                _compressed_sides(spread))], fits_jax=False)
    # a block longer than the kernel's stage (its codes and states in a
    # global scratch), beside a short block in the same launch
    n = ENCODE_STAGE_CAP + 117
    out["above the stage cap"] = _case([
        _block(rng, _predefined_codes(rng, n), _predefined_sides()),
        _block(rng, _predefined_codes(rng, 90), _predefined_sides())])
    # 300 blocks of one to three sequences beside one of 3,000, tables mixed
    pool = _wide_codes(rng, 400)
    pool_sides = _compressed_sides(pool)
    tiny = []
    for i in range(300):
        k = int(rng.integers(1, 4))
        if i % 3 == 0:
            tiny.append(_block(rng, _predefined_codes(rng, k), _predefined_sides()))
        elif i % 3 == 1:
            tiny.append(_block(rng, tuple(rng.choice(c, k) for c in pool), pool_sides))
        else:  # one machine in each mode
            c = int(rng.integers(0, zseq.LL_CODE_MAX + 1))
            tiny.append(_block(rng, (np.full(k, c), rng.choice(pool[1], k),
                                     rng.integers(0, zseq.ML_CODE_MAX + 1, k)),
                               (_rle(c), pool_sides[1], _predefined("ml"))))
    tiny.insert(150, _block(rng, tuple(rng.choice(c, 3000) for c in pool), pool_sides))
    out["tiny blocks beside a long one"] = _case(tiny)
    # the packing's tile edges: the first row alone writes no state bits
    out["tile edges"] = _case([_block(rng, tuple(rng.choice(c, n) for c in pool), pool_sides)
                               for n in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1)])
    # bits that end on a word (the sentinel opens a new one) and one short
    # of it (the sentinel closes the word)
    out["ends on a word"] = _case([_ending_on(rng, 0, 20), _ending_on(rng, 31, 21),
                                   _ending_on(rng, 0, TILE + 3)])
    return out
