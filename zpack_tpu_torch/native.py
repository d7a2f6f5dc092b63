"""ctypes loader for the native host backend (native/zpack_native.cpp).

The port's library also holds ``native/zstd_walk.cpp``, the walk of a zstd
entry into the device decoders' batches (:class:`ZstdWalk`),
``native/zstd_read.cpp``, the host layout of a zstd read on the card
(``kernels/zstd_chain.py``), and ``native/lz4_hc.cpp``, the LZ4 serializer
of the HC parse (:func:`lz4_serialize_blocks_hc`), which the JAX package's
library does not.

Builds the shared library on first use with g++, from the repository's
``native/`` sources into ``zpack_tpu_torch/_build/`` (which git ignores), so
every machine compiles its own ``-march=native`` library; all callers fall
back to the numpy paths when the toolchain or binary is unavailable, so the
pure-Python framework remains fully functional.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
import threading

import numpy as np

from .utils.observe import metrics

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRCS = [
    _ROOT / "native" / "zpack_native.cpp",
    _ROOT / "native" / "zstd_decode.cpp",
    _ROOT / "native" / "zstd_encode.cpp",
    _ROOT / "native" / "zstd_walk.cpp",
    _ROOT / "native" / "zstd_read.cpp",
    _ROOT / "native" / "lz4_hc.cpp",
]
#: headers the sources include: an edited one rebuilds the library too
_HEADERS = [_ROOT / "zpack_tpu_torch" / "csrc" / "zstd_chain.cuh"]
_SO = pathlib.Path(__file__).resolve().parent / "_build" / "_zpack_native.so"
# Prebuilt .so override (e.g. a sanitizer build from scripts/sanitize_native.py)
_SO_OVERRIDE = os.environ.get("ZPACK_TPU_NATIVE_SO")
if _SO_OVERRIDE:
    _SO = pathlib.Path(_SO_OVERRIDE)


def _build() -> bool:
    if _SO_OVERRIDE:
        return _SO.exists()  # never rebuild an explicit override
    srcs = [s for s in _SRCS if s.exists()]
    if not srcs:
        return False

    def fresh() -> bool:
        return _SO.exists() and all(_SO.stat().st_mtime >= s.stat().st_mtime
                                    for s in srcs + [h for h in _HEADERS if h.exists()])

    if fresh():
        return True
    # One build at a time across processes (a file lock), under a name of
    # its own and renamed into place: a process that arrives meanwhile waits
    # and then finds the finished library, and never loads a half-written one.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        with open(_SO.with_name(".native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if fresh():
                return True
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 *[str(s) for s in srcs], "-o", str(tmp)],
                check=True, capture_output=True, timeout=180,
            )
            os.replace(tmp, _SO)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ZPACK_TPU_NO_NATIVE"):
            return None
        with metrics.phase("native.load"):  # the g++ build, or the cached library's load
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(str(_SO))
            except OSError:
                return None
        lib.zn_xxh3_64.restype = ctypes.c_uint64
        lib.zn_xxh3_64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.zn_lz4_compress.restype = ctypes.c_size_t
        lib.zn_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.zn_lz4_decompress.restype = ctypes.c_size_t
        lib.zn_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.zn_zstd_decompress.restype = ctypes.c_size_t
        lib.zn_zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.zn_zstd_compress.restype = ctypes.c_size_t
        lib.zn_zstd_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.zn_lz4f_compress.restype = ctypes.c_size_t
        lib.zn_lz4f_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.zn_lz4f_decompress.restype = ctypes.c_size_t
        lib.zn_lz4f_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        for fn in (lib.zn_lz4f_compress_chunked, lib.zn_zstd_compress_chunked):
            fn.restype = ctypes.c_size_t
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
            ]
        lib.zn_compress_batch.restype = ctypes.c_size_t
        lib.zn_compress_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.zn_decompress_batch.restype = ctypes.c_size_t
        lib.zn_decompress_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.zn_zstd_dstream_new.restype = ctypes.c_void_p
        lib.zn_zstd_dstream_new.argtypes = []
        lib.zn_zstd_dstream_free.restype = None
        lib.zn_zstd_dstream_free.argtypes = [ctypes.c_void_p]
        lib.zn_zstd_dstream_feed.restype = ctypes.c_int
        lib.zn_zstd_dstream_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.zn_zstd_dstream_pending.restype = ctypes.c_size_t
        lib.zn_zstd_dstream_pending.argtypes = [ctypes.c_void_p]
        lib.zn_zstd_dstream_read.restype = ctypes.c_size_t
        lib.zn_zstd_dstream_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.zn_lz4_serialize_blocks.restype = ctypes.c_size_t
        lib.zn_lz4_serialize_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.zn_lz4_serialize_blocks_u16.restype = ctypes.c_size_t
        lib.zn_lz4_serialize_blocks_u16.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.zn_lz4_serialize_blocks_pair.restype = ctypes.c_size_t
        lib.zn_lz4_serialize_blocks_pair.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        if hasattr(lib, "zn_lz4_serialize_blocks_hc"):
            lib.zn_lz4_serialize_blocks_hc.restype = ctypes.c_size_t
            lib.zn_lz4_serialize_blocks_hc.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
        lib.zn_xxh3_new.restype = ctypes.c_void_p
        lib.zn_xxh3_new.argtypes = []
        lib.zn_xxh3_free.restype = None
        lib.zn_xxh3_free.argtypes = [ctypes.c_void_p]
        lib.zn_xxh3_update.restype = None
        lib.zn_xxh3_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.zn_xxh3_digest.restype = ctypes.c_uint64
        lib.zn_xxh3_digest.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "zw_literals"):  # absent from a library built elsewhere
            lib.zw_literals.restype = ctypes.c_void_p
            lib.zw_literals.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
            lib.zw_sequences.restype = ctypes.c_int
            lib.zw_sequences.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.zw_free.restype = None
            lib.zw_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "zr_layout"):
            p = ctypes.c_void_p
            lib.zr_layout.restype = ctypes.c_int
            lib.zr_layout.argtypes = [p, ctypes.c_int64, p]
            lib.zr_replay_layout.restype = ctypes.c_int
            lib.zr_replay_layout.argtypes = [p, p]
            lib.zr_pack.restype = None
            lib.zr_pack.argtypes = [p, p, p]
        _LIB = lib
        return _LIB


_FAIL = (1 << 64) - 1  # (size_t)-1 from the C side
_SCRATCH = threading.local()  # reusable compress_chunked output scratch


def xxh3_64(data: bytes) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.zn_xxh3_64(data, len(data)))


def _outbuf(cap: int):
    """Uninitialized output buffer (np.empty: no O(cap) zero-fill, pages
    materialize lazily — corrupt size fields must not become a DoS)."""
    arr = np.empty(max(cap, 1), dtype=np.uint8)
    return arr, arr.ctypes.data


_pyapi = ctypes.pythonapi
_pyapi.PyBytes_FromStringAndSize.restype = ctypes.py_object
_pyapi.PyBytes_FromStringAndSize.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
_pyapi.PyBytes_AsString.restype = ctypes.c_void_p
_pyapi.PyBytes_AsString.argtypes = [ctypes.py_object]


def _bytes_out(cap: int):
    """Uninitialized `bytes` of length cap + its writable address.

    The single-reference-mutation idiom C extensions use: the native call
    fills the object in place, so when the produced size equals cap (the
    common decompress case — content size is known) the result is returned
    with ZERO extra copies, vs np.empty scratch + .tobytes() (a full second
    pass over the output).

    INVARIANT (CPython-specific): the returned object holds exactly one
    reference and must not be read, hashed, interned, or otherwise escape
    before the native call fills it; callers return it (or a slice of it)
    only after the fill.  On non-CPython runtimes ctypes.pythonapi is absent
    and the import of this module would fail long before reaching here."""
    b = _pyapi.PyBytes_FromStringAndSize(None, max(cap, 1))
    return b, _pyapi.PyBytes_AsString(b)


def compress_batch(datas: list[bytes], methods: list[int], levels: list[int]):
    """Compress + XXH3-hash N entries in ONE native call (worker threads
    inside the library; methods: 0=store 1=zstd 2=lz4f).  Returns
    (compressed list, hash list) or None when unavailable/failed."""
    lib = get_lib()
    if lib is None or not datas:
        return None
    n = len(datas)
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(d) for d in datas], out=offs[1:])
    src = b"".join(datas)
    caps = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(d) + len(d) // 255 + 512 for d in datas], out=caps[1:])
    dst = np.empty(int(caps[-1]), dtype=np.uint8)
    sizes = np.zeros(n, dtype=np.uint64)
    hashes = np.zeros(n, dtype=np.uint64)
    m = np.asarray(methods, dtype=np.int32)
    lv = np.asarray(levels, dtype=np.int32)
    fails = int(lib.zn_compress_batch(
        src, offs.ctypes.data, n, m.ctypes.data, lv.ctypes.data,
        dst.ctypes.data, caps.ctypes.data, sizes.ctypes.data, hashes.ctypes.data))
    if fails:
        return None
    out = [dst[int(caps[i]) : int(caps[i]) + int(sizes[i])].tobytes() for i in range(n)]
    return out, [int(h) for h in hashes]


def decompress_batch(buf: bytes, comp_offs, comp_sizes, methods, out_sizes, hashes):
    """Decompress + XXH3-verify N entries of an archive buffer in ONE
    native call (read-side analog of compress_batch).  Returns
    (list of bytes, fail_mask list) or None when unavailable."""
    lib = get_lib()
    if lib is None or not comp_offs:
        return None
    n = len(comp_offs)
    co = np.asarray(comp_offs, dtype=np.uint64)
    cs = np.asarray(comp_sizes, dtype=np.uint64)
    m = np.asarray(methods, dtype=np.int32)
    oo = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(np.asarray(out_sizes, dtype=np.uint64), out=oo[1:])
    h = np.asarray(hashes, dtype=np.uint64)
    dst = np.empty(max(int(oo[-1]), 1), dtype=np.uint8)
    mask = np.zeros(n, dtype=np.uint8)
    lib.zn_decompress_batch(
        buf, co.ctypes.data, cs.ctypes.data, n, m.ctypes.data,
        dst.ctypes.data, oo.ctypes.data, h.ctypes.data, mask.ctypes.data)
    outs = [dst[int(oo[i]) : int(oo[i + 1])].tobytes() if not mask[i] else None
            for i in range(n)]
    return outs, mask.tolist()


def lz4_serialize_blocks(data: bytes, src: "np.ndarray", mlen: "np.ndarray",
                         block_size: int) -> bytes | None:
    """Assemble lz4f block sections from device match tables in one native
    call (greedy parse + exact extension + emission, threaded over blocks).
    src/mlen: (nb, block_size) int32 rows from the TPU tokenizer."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return b""
    src = np.ascontiguousarray(src, dtype=np.int32)
    mlen = np.ascontiguousarray(mlen, dtype=np.int32)
    nb = -(-n // block_size)
    assert src.shape == mlen.shape and src.shape[0] >= nb and src.shape[1] == block_size
    cap = n + (n // 255) + 20 * nb + 64
    out, optr = _bytes_out(cap)
    r = int(lib.zn_lz4_serialize_blocks(
        data, n, block_size, src.ctypes.data, mlen.ctypes.data, nb, optr, cap
    ))
    if r == _FAIL:
        return None
    return out[:r]


def lz4_serialize_blocks_packed(data: bytes, mode: str, arrays,
                                block_size: int) -> bytes | None:
    """Like :func:`lz4_serialize_blocks` but consuming the device kernel's
    packed wire formats directly (no host unpack pass — the round-2
    scaling bottleneck): mode "u16" takes one (nb, B) uint16 token array,
    mode "pair" takes ((nb, B) uint16 src, (nb, B) uint8 code)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return b""
    nb = -(-n // block_size)
    cap = n + (n // 255) + 20 * nb + 64
    out, optr = _bytes_out(cap)
    if mode == "u16":
        (tok,) = arrays
        tok = np.ascontiguousarray(tok, dtype=np.uint16)
        assert tok.shape[0] >= nb and tok.shape[1] == block_size
        r = int(lib.zn_lz4_serialize_blocks_u16(
            data, n, block_size, tok.ctypes.data, nb, optr, cap))
    elif mode == "pair":
        src16, code = arrays
        src16 = np.ascontiguousarray(src16, dtype=np.uint16)
        code = np.ascontiguousarray(code, dtype=np.uint8)
        assert src16.shape[0] >= nb and src16.shape[1] == block_size
        assert code.shape == src16.shape
        r = int(lib.zn_lz4_serialize_blocks_pair(
            data, n, block_size, src16.ctypes.data, code.ctypes.data,
            nb, optr, cap))
    else:
        return None
    if r == _FAIL:
        return None
    return out[:r]


def lz4_serialize_blocks_hc(data: bytes, mode: str, arrays,
                            block_size: int) -> bytes | None:
    """:func:`lz4_serialize_blocks_packed` in the HC parse of LZ4's
    high-compression levels (``lz4_torch.serialize_plain`` with parse
    "hc"), from the same wire arrays.  None where the library or its HC
    entry point is missing, or a block overflows."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "zn_lz4_serialize_blocks_hc"):
        return None
    n = len(data)
    if n == 0:
        return b""
    nb = -(-n // block_size)
    if mode == "pair":
        t0 = np.ascontiguousarray(arrays[0], dtype=np.uint16)
        t1 = np.ascontiguousarray(arrays[1], dtype=np.uint8)
        assert t1.shape == t0.shape
    elif mode == "u16":
        t0, t1 = np.ascontiguousarray(arrays[0], dtype=np.uint16), None
    else:
        return None
    assert t0.shape[0] >= nb and t0.shape[1] == block_size
    cap = n + (n // 255) + 20 * nb + 64
    out, optr = _bytes_out(cap)
    r = int(lib.zn_lz4_serialize_blocks_hc(
        data, n, block_size, 0 if mode == "pair" else 1, t0.ctypes.data,
        None if t1 is None else t1.ctypes.data, nb, optr, cap))
    if r == _FAIL:
        return None
    return out[:r]


def lz4_compress_block(data: bytes, level: int = 1) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 255 + 64
    arr, buf = _outbuf(cap)
    n = int(lib.zn_lz4_compress(data, len(data), buf, cap, level))
    if n == _FAIL:
        return None
    return arr[:n].tobytes()


def lz4_decompress_block(data: bytes, max_out: int, prefix: bytes = b"") -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out, buf = _bytes_out(max_out)
    n = int(lib.zn_lz4_decompress(data, len(data), buf, max_out, prefix, len(prefix)))
    if n == _FAIL:
        return None
    return out if n == len(out) else out[:n]


def lz4f_compress(data: bytes, level: int = 1) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 255 + 4 * (len(data) // (64 << 10) + 2) + 64
    arr, buf = _outbuf(cap)
    n = int(lib.zn_lz4f_compress(data, len(data), buf, cap, level))
    if n == _FAIL:
        return None
    return arr[:n].tobytes()


def _chunked_fn(method: int):
    lib = get_lib()
    if lib is None:
        return None
    return lib.zn_zstd_compress_chunked if method == 1 else lib.zn_lz4f_compress_chunked


def _chunked_cap(n: int, chunk: int) -> int:
    nframes = (n + chunk - 1) // chunk if n else 1
    return n + n // 128 + nframes * 64 + 4096


def compress_chunked(method: int, data: bytes, level: int,
                     chunk: int = 2 << 20):
    """Fused whole-entry compress: consecutive frames of ``chunk`` input
    bytes + the XXH3-64 of the whole input, in ONE native call on one
    worker pool.  Compresses into a reusable per-thread numpy scratch and
    returns (view, hash) where ``view`` is a zero-copy np.uint8 slice of
    it — the writer emits the view straight into its sink (one copy of
    the compressed size; an in-place-into-the-heap variant measured WORSE
    because growing the bytearray zero-fills the full input-sized cap).
    Returns None when the native backend is unavailable."""
    fn = _chunked_fn(method)
    if fn is None:
        return None
    n = len(data)
    cap = _chunked_cap(n, chunk)
    # reusable per-thread scratch: fresh np.empty would page-fault every
    # output byte on every call (the pages are new anon mappings); reuse
    # makes repeated large writes fault-free after the first
    tl = _SCRATCH
    arr = getattr(tl, "arr", None)
    if arr is None or arr.size < cap:
        arr = np.empty(cap, dtype=np.uint8)
        tl.arr = arr
    h = ctypes.c_uint64(0)
    r = int(fn(data, n, chunk, arr.ctypes.data, cap, level, ctypes.byref(h)))
    if r == _FAIL:
        return None
    # memoryview: bytearray slice-assignment accepts it zero-copy (it
    # rejects ndarray directly).  NOTE: the view aliases the shared
    # scratch — it is only valid until this thread's next call; callers
    # (the writer fused path) copy it into their sink immediately.
    return memoryview(arr[:r]), int(h.value)


def lz4f_decompress(data: bytes, max_out: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out, buf = _bytes_out(max_out)
    n = int(lib.zn_lz4f_decompress(data, len(data), buf, max_out))
    if n == _FAIL:
        return None
    return out if n == len(out) else out[:n]


_RAW = None


def _raw_lib() -> ctypes.CDLL | None:
    """Second handle onto the same .so with pointer-typed (c_void_p)
    signatures, for calls that pass raw address offsets into shared
    buffers (ctypes caches function objects per CDLL instance, so this
    leaves the bytes-typed signatures on the main handle untouched)."""
    global _RAW
    if _RAW is None:
        if get_lib() is None:
            return None
        _RAW = ctypes.CDLL(str(_SO))
        _RAW.zn_lz4f_decompress.restype = ctypes.c_size_t
        _RAW.zn_lz4f_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    return _RAW


def lz4f_decompress_frames(data: bytes, bounds) -> bytes | None:
    """Decode concatenated lz4 frames IN PARALLEL straight into one output
    buffer — src/dst are raw address offsets, so there is no per-frame
    slice copy and no join copy (the copying ThreadPool version measured
    SLOWER than sequential; this one scales with cores).

    ``bounds``: [(start, end, content_size)] per frame, as produced by
    parallel.host._scan_lz4f_frames.  Returns None on any frame failure.
    """
    raw = _raw_lib()
    if raw is None:
        return None
    import concurrent.futures as cf

    total = sum(b[2] for b in bounds)
    out, optr = _bytes_out(total)
    src_addr = _pyapi.PyBytes_AsString(data)
    offs = []
    acc = 0
    for _, _, cs in bounds:
        offs.append(acc)
        acc += cs
    fn = raw.zn_lz4f_decompress

    def one(i: int) -> bool:
        s, e, cs = bounds[i]
        n = int(fn(src_addr + s, e - s, optr + offs[i], cs))
        return n == cs

    workers = max(1, min(8, os.cpu_count() or 1))
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        ok = list(ex.map(one, range(len(bounds))))
    if not all(ok):
        return None
    return out if total == len(out) else out[:total]


def zstd_compress(data: bytes, level: int = 3) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + (len(data) >> 7) + 1024
    arr, buf = _outbuf(cap)
    n = int(lib.zn_zstd_compress(data, len(data), buf, cap, level))
    if n == _FAIL:
        return None
    return arr[:n].tobytes()


def zstd_decompress(data: bytes, max_out: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out, buf = _bytes_out(max_out)
    n = int(lib.zn_zstd_decompress(data, len(data), buf, max_out))
    if n == _FAIL:
        return None
    return out if n == len(out) else out[:n]


class NativeZstdDStream:
    """Incremental zstd streaming decoder over the native backend
    (zn_zstd_dstream_*): blocks decode the moment they complete into a
    rolling window, so arbitrarily long single frames stream in bounded
    memory at native speed (role parity: ZSTD_decompressStream as used by
    lib/zpack_read.c:572)."""

    def __init__(self):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native backend unavailable")
        self._lib = lib
        self._ptr = lib.zn_zstd_dstream_new()
        if not self._ptr:
            raise MemoryError("zn_zstd_dstream_new failed")

    def feed(self, data: bytes, is_final: bool = False) -> bytes:
        """Feed one chunk; returns every byte decoded by it."""
        rc = self._lib.zn_zstd_dstream_feed(
            self._ptr, bytes(data), len(data), 1 if is_final else 0
        )
        if rc != 0:
            from .errors import DecompressError

            raise DecompressError("native zstd stream decode failed")
        pending = int(self._lib.zn_zstd_dstream_pending(self._ptr))
        if not pending:
            return b""
        out, buf = _bytes_out(pending)
        got = int(self._lib.zn_zstd_dstream_read(self._ptr, buf, pending))
        return out if got == len(out) else out[:got]

    def __del__(self):
        try:
            self._lib.zn_zstd_dstream_free(self._ptr)
        except Exception:
            pass


def zstd_dstream():
    """Native incremental dstream or None when unavailable."""
    if get_lib() is None:
        return None
    try:
        return NativeZstdDStream()
    except Exception:
        return None


class NativeXXH3State:
    """Streaming XXH3-64 over the native backend (seed 0)."""

    def __init__(self):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native backend unavailable")
        self._lib = lib
        self._ptr = lib.zn_xxh3_new()

    def update(self, data: bytes):
        self._lib.zn_xxh3_update(self._ptr, bytes(data), len(data))
        return self

    def digest(self) -> int:
        return int(self._lib.zn_xxh3_digest(self._ptr))

    def __del__(self):
        try:
            self._lib.zn_xxh3_free(self._ptr)
        except Exception:
            pass


def xxh3_state():
    """Native streaming state or None when unavailable."""
    if get_lib() is None:
        return None
    return NativeXXH3State()


# ---------------------------------------------------------------------------
# zstd walk (native/zstd_walk.cpp)
# ---------------------------------------------------------------------------


class _ZwLiterals(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int64) for k in ("n_frames", "n_blocks", "n_streams", "n_tables",
                                                "n_runs", "lit_row")]
                + [(k, ctypes.c_void_p) for k in ("frame_chk", "blocks", "streams",
                                                   "tables", "runs", "frame_size")])


class _ZwSequences(ctypes.Structure):
    _fields_ = [("n_items", ctypes.c_int64)] + [
        (k, ctypes.c_void_p) for k in ("rows", "seq_off", "al", "tables", "slots")]


def _copy_out(ptr, dtype, shape) -> np.ndarray:
    """A numpy copy of the native array at ``ptr``."""
    out = np.empty(shape, dtype)
    if out.nbytes:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    return out


def zstd_walk_lib() -> ctypes.CDLL | None:
    """The library when it holds the zstd walk, else None."""
    lib = get_lib()
    return lib if lib is not None and hasattr(lib, "zw_literals") else None


def zstd_read_lib() -> ctypes.CDLL | None:
    """The library when it holds the zstd read's host layout, else None."""
    lib = get_lib()
    return lib if lib is not None and hasattr(lib, "zr_layout") else None


class ZstdWalk:
    """The native walk of one zstd entry, in two passes: :meth:`literals`,
    then :meth:`sequences`.  Each returns its arrays, copied out, or None
    where the walk rejects the input: then the Python walk
    (``parallel/extract.walk_zstd``) either raises its error or accepts
    what this one does not.  A context manager: the native walk is freed
    on leaving it."""

    def __init__(self, lib: ctypes.CDLL, data: bytes):
        self._lib, self._data = lib, bytes(data)  # the walk points into ``_data``
        self._handle = None
        self._n_blocks = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._handle:
            self._lib.zw_free(self._handle)
            self._handle = None
        return False

    def literals(self) -> dict | None:
        """Frames, blocks, literals sections and Huffman tables:
        ``frame_chk`` (F,) (-1 for no checksum), ``blocks`` (NB, 6) (frame,
        offset, size, lits_end, literal bytes, block type), ``streams`` (S,
        7) (``huffman_torch.DECODE_COLS``, offsets into the entry, each
        destination placed), ``tables`` (T, 2048) int32, ``runs`` (R, 4),
        the raw and RLE literal runs (length, destination, source in the
        entry, step: 1 raw, 0 one byte repeated), ``lit_row``, the bytes of
        a frame's literal row, and ``frame_size`` (F,), each frame's
        declared content size (-1 for none)."""
        out = _ZwLiterals()
        self._handle = self._lib.zw_literals(self._data, len(self._data), ctypes.byref(out))
        if not self._handle:
            return None
        self._n_blocks = out.n_blocks
        i64 = np.int64
        return {"frame_chk": _copy_out(out.frame_chk, i64, out.n_frames),
                "blocks": _copy_out(out.blocks, i64, (out.n_blocks, 6)),
                "streams": _copy_out(out.streams, i64, (out.n_streams, 7)),
                "tables": _copy_out(out.tables, np.int32, (out.n_tables, 2048)),
                "runs": _copy_out(out.runs, i64, (out.n_runs, 4)),
                "lit_row": int(out.lit_row),
                "frame_size": _copy_out(out.frame_size, i64, out.n_frames)}

    def sequences(self) -> dict | None:
        """Sequences sections and FSE tables, after :meth:`literals`:
        ``fse_torch.build_decode_batch``'s ``rows`` (offsets into the
        entry), ``seq_off``, ``al`` and ``tables``, and ``slots`` (NB,),
        each block's item or -1."""
        out = _ZwSequences()
        if self._lib.zw_sequences(self._handle, ctypes.byref(out)):
            return None
        B, i64 = out.n_items, np.int64
        return {"rows": _copy_out(out.rows, i64, (B, 3)),
                "seq_off": _copy_out(out.seq_off, i64, B + 1),
                "al": _copy_out(out.al, np.int32, (B, 3)),
                "tables": _copy_out(out.tables, np.int32, (B, 3, 512)),
                "slots": _copy_out(out.slots, i64, self._n_blocks)}
