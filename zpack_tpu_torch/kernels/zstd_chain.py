"""One zstd read on the card from native code: the host layout and upload
(``native/zstd_read.cpp``) and the launch chain (``csrc/zstd_chain.cu``).

Written for the card, with no TPU original.  The read's Python enqueue
(``parallel/extract._decode_python``) sizes the read in numpy, packs about
twelve arrays into one pinned upload and makes some ten launches through
the decoders' and the assembly's wrappers, a ctypes call, a stream lookup
and an argument check each.  Here the plan's arrays go to native code
whole:

* :class:`Layout` (host, one call): what the Python enqueue computes, and
  the byte offset of every array of the upload and of every device buffer
  of the read in one arena, as the int64 words of :data:`SLOTS`;
* :meth:`Layout.pack` (host, one call): the upload into a pinned buffer,
  one ``memcpy`` an array;
* :func:`enqueue` (one call a part): on the current stream, the upload,
  the zero fills (``cudaMemsetAsync``), the kernels of today through their
  own entry points in today's order, and the read-back into pinned memory;
  every kernel launched is recorded as its wrapper records it.

The kernels and the bytes they compute are those of the Python route;
:mod:`zstd_chain` only moves the host's enqueue into native code.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.observe import launched
from . import _build, huffman_torch

#: the plan's words (``ZpSlot`` in ``csrc/zstd_chain.cuh``)
PLAN_SLOTS = ("F", "NB", "S", "T", "B", "R", "LB", "N", "FRAME_SIZE", "BLOCKS", "HUF_ROWS",
              "HUF_TABLES", "FSE_ROWS", "SEQ_OFF", "FSE_AL", "FSE_TABLES", "RUNS", "SOURCE")
#: the layout's words (``ZrSlot`` in ``csrc/zstd_chain.cuh``, the same order)
SLOTS = ("F", "NB", "S", "T", "B", "R", "LB", "N", "SEQS", "MAX_OUT", "EXACT", "SB", "CAP",
         "HUF_STAGE", "FSE_WIDEST", "FSE_LONGEST", "REC_WORDS",
         "TOTAL", "N_OUT", "FSTRIDE", "TILES",
         "UP_BLK", "UP_FIRST", "UP_SEQ_OFF", "UP_RUNS", "UP_DECLARED", "UP_OFFSETS",
         "UP_SOURCE", "UP_HUF_ROWS", "UP_HUF_TABLES", "UP_FSE_ROWS", "UP_FSE_AL",
         "UP_FSE_TABLES", "UP_BYTES",
         "A_LITS", "A_FINAL", "A_LLS", "A_MLS", "A_OVS", "A_FREC", "A_POS_F", "A_FERR",
         "A_SEL", "A_VAL", "A_SUMS", "A_REC", "A_ENTRY", "A_BASES", "A_FRAME_OUT", "A_OFFS",
         "A_REP_ERR", "A_SEG", "A_BYTES",
         "B_OFFSETS", "B_ROWS", "B_F", "B_LIVE", "B_STATE", "B_OUT", "B_BYTES",
         "BACK_BYTES", "PIN_BACK", "PIN_BYTES")
_AT = {name: i for i, name in enumerate(SLOTS)}
#: the kernels the chain launches, by the code it reports (``Kernel`` in
#: ``csrc/zstd_chain.cu``): the keys their Python wrappers record
KERNELS = ("huffman_decode", "fse_decode", "rep_totals", "zstd_stitch", "rep_apply",
           "zstd_layout", "lz4_replay", "zstd_trim")
#: the chain's parts (``zr::Part``): upload to layout; the stitch again at
#: no declared size; replay, trim and read-back
PART_A, PART_RESTITCH, PART_B = 1, 2, 4
#: what the layout refuses, by its code (``zr::Refusal``), as the wrappers
#: refuse it: ``ValueError`` before any launch
_FSE_TOO_LONG = ("a block of 2**23 sequences or a row of 2**26 bytes is beyond the kernel's "
                 "int32 bit positions")
_REPLAY_TOO_LONG = "too many bytes for one replay launch"


def _addr(a) -> int:
    return a.ctypes.data if a is not None and a.size else 0


class Layout:
    """The native layout of one read of a ``ZstdPlan`` (at least one frame,
    no pending ``error``) with the output bound ``max_out``:
    ``layout[name]`` reads a word of :data:`SLOTS` as an int.  Raises the
    ValueError a wrapper of the Python route would raise before its launch.
    Holds the plan's arrays while native code reads them."""

    __slots__ = ("words", "_arrays", "d")

    def __init__(self, plan, max_out: int | None):
        huf, fse = plan.huffman, plan.sequences
        i64, i32 = np.int64, np.int32
        self._arrays = arrays = [
            np.ascontiguousarray(plan.frame_size, i64), np.ascontiguousarray(plan.blocks, i64),
            None if huf is None else np.ascontiguousarray(huf["rows"], i64),
            None if huf is None else np.ascontiguousarray(huf["tables"], i32),
            None if fse is None else np.ascontiguousarray(fse["rows"], i64),
            None if fse is None else np.ascontiguousarray(fse["seq_off"], i64),
            None if fse is None else np.ascontiguousarray(fse["al"], i32),
            None if fse is None else np.ascontiguousarray(fse["tables"], i32),
            np.ascontiguousarray(plan.runs, i64), np.ascontiguousarray(plan.source, np.uint8)]
        fs, blk, hr, ht, fr, so, _, _, runs, src = arrays
        self.words = np.array(
            [len(fs), len(blk), 0 if hr is None else len(hr), 0 if ht is None else len(ht),
             0 if fr is None else len(fr), len(runs), plan.lit_row, src.size]
            + [_addr(a) for a in arrays], dtype=i64)
        self.d = np.empty(len(SLOTS), i64)
        rc = native.get_lib().zr_layout(self.words.ctypes.data,
                                        -1 if max_out is None else max_out, self.d.ctypes.data)
        if rc:
            self._refuse(rc, plan)

    def __getitem__(self, name: str) -> int:
        return int(self.d[_AT[name]])

    @staticmethod
    def _refuse(rc: int, plan):
        if rc == 1:  # the Huffman wrapper's own message
            huffman_torch.stage_size(int(plan.huffman["rows"][:, 1].max()))
        raise ValueError(_FSE_TOO_LONG if rc == 2 else _REPLAY_TOO_LONG)

    def pack(self, dst: torch.Tensor) -> None:
        """The upload (``UP_BYTES``) into the head of ``dst``, a uint8 host
        tensor of at least that many bytes."""
        if dst.device.type != "cpu" or dst.numel() < self["UP_BYTES"]:
            raise ValueError("the upload needs UP_BYTES of host memory")
        native.get_lib().zr_pack(self.words.ctypes.data, self.d.ctypes.data, dst.data_ptr())

    def replay(self, sizes: np.ndarray) -> None:
        """Part B's words for the frames' computed ``sizes`` (int64): its
        buffers, and its own pinned buffer, the frames' offsets
        (``PIN_BACK`` bytes) then the read-back (``BACK_BYTES``)."""
        sizes = np.ascontiguousarray(sizes, np.int64)
        rc = native.get_lib().zr_replay_layout(self.d.ctypes.data, sizes.ctypes.data)
        if rc:
            raise ValueError(_REPLAY_TOO_LONG)


def enqueue(lay: Layout, parts: int, pinned: torch.Tensor, arena: torch.Tensor, *,
            part_b: int = 0, offsets: torch.Tensor | None = None,
            back: int = 0) -> None:
    """The chain's ``parts`` on ``arena``'s device, on its current stream:
    ``pinned`` the packed upload, ``arena`` at least ``A_BYTES`` of device
    memory, ``part_b`` the address of part B's buffers (0: right after part
    A in ``arena``), ``offsets`` the frames' offsets in pinned memory where
    the upload lacks them, ``back`` the address of the pinned read-back.
    Every buffer has to live until the stream has run the chain."""
    dev = arena.device
    need = lay["A_BYTES"] + (lay["B_BYTES"] if parts & PART_B and not part_b else 0)
    if arena.numel() < need or (parts & PART_A and pinned.numel() < lay["UP_BYTES"]):
        raise ValueError("the arena or the upload is smaller than the layout's")
    codes, count = np.empty(16, np.int32), np.zeros(1, np.int32)
    with torch.cuda.device(dev):
        rc = _build.lib().zp_zstd_chain(
            lay.d.ctypes.data, parts, pinned.data_ptr(), arena.data_ptr(),
            part_b or arena.data_ptr() + lay["A_BYTES"],
            0 if offsets is None else offsets.data_ptr(), back, codes.ctypes.data,
            count.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    for k in codes[:int(count[0])].tolist():
        launched(KERNELS[k])
    _build.check(rc, "zstd_chain")
