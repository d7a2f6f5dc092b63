"""Build and load the hand-written CUDA kernels (``zpack_tpu_torch/csrc``).

The kernels compile at first use with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and link into one shared library
with a plain C interface, loaded with ``ctypes`` — the build-at-first-use
pattern of ``zpack_tpu/native.py``.  The library is keyed by a hash of the
sources, headers and flags, so an edited source rebuilds and an unchanged
one loads at once.  It lands in ``zpack_tpu_torch/_build/``, which git
ignores.

Every C entry point takes each pointer and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  A missing toolchain or a failed build raises too: there is
no fallback to the plain versions for a tensor on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

from ..utils.observe import metrics

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    pass


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"zpack_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for them already exists: one
    ``nvcc -c`` per source, all at once, then one link.  Works in a
    temporary directory and renames the library into place, so a process
    building at the same time never loads a half-written file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        procs = []
        try:
            for src, obj in zip(_sources(), objs):
                # each compiler writes its messages to a file: a full pipe
                # would stall it while another one is awaited
                with open(f"{obj}.log", "w") as log:
                    procs.append(subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                        stdout=log, stderr=subprocess.STDOUT))
            failed = []
            for src, obj, proc in zip(_sources(), objs, procs):
                if proc.wait(timeout=BUILD_TIMEOUT_S) != 0:
                    with open(f"{obj}.log") as log:
                        failed.append(f"{src.name} ({proc.returncode}):\n{log.read()[-4000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise KernelBuildError("nvcc failed: " + "\n".join(failed))
        out = os.path.join(tmp, so.name)
        res = subprocess.run([nvcc, "-shared", "-o", out, *objs], capture_output=True,
                             text=True, timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(out, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with metrics.phase("kernels.load"):  # the nvcc build, or the cached library's load
                cdll = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            cdll.zp_lz4_tokenize.restype = i
            cdll.zp_lz4_tokenize.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p]
            cdll.zp_lz4_replay.restype = i
            cdll.zp_lz4_replay.argtypes = [p, i, p, p, p, p, p, p, i, i, i, p, p, i, p, p, p]
            cdll.zp_lz4_serialize.restype = i
            cdll.zp_lz4_serialize.argtypes = [p, i, i, ctypes.c_longlong, i, i, p, p, p,
                                              ctypes.c_longlong, p, i, p, p, p]
            cdll.zp_lz4_parse_walk.restype = i
            cdll.zp_lz4_parse_walk.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p]
            cdll.zp_lz4_parse_occupancy.restype = i
            cdll.zp_lz4_parse_occupancy.argtypes = [i, p]
            cdll.zp_lz4_parse_layout.restype = i
            cdll.zp_lz4_parse_layout.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]
            i64 = ctypes.c_longlong
            cdll.zp_xxh3_batch.restype = i
            cdll.zp_xxh3_batch.argtypes = [p, i64, p, i, p, p, p, p]
            cdll.zp_xxh3_batch_shape.restype = i
            cdll.zp_xxh3_batch_shape.argtypes = [i, p]
            cdll.zp_xxh3_stream.restype = i
            cdll.zp_xxh3_stream.argtypes = [p, i64, p, p, p, p, p]
            cdll.zp_huffman_encode.restype = i
            cdll.zp_huffman_encode.argtypes = [p, p, p, i, p, p, p]
            cdll.zp_launch_floor.restype = i
            cdll.zp_launch_floor.argtypes = [i, p]
            cdll.zp_fse_encode.restype = i
            cdll.zp_fse_encode.argtypes = [p, p, p, p, p, i, i, i, p, p, p, p]
            cdll.zp_fse_encode_occupancy.restype = i
            cdll.zp_fse_encode_occupancy.argtypes = [i, p]
            cdll.zp_huffman_decode.restype = i
            cdll.zp_huffman_decode.argtypes = [p, i64, p, i, p, i, p, i64, p, i, p]
            cdll.zp_huffman_decode_occupancy.restype = i
            cdll.zp_huffman_decode_occupancy.argtypes = [i, p]
            cdll.zp_fse_decode.restype = i
            cdll.zp_fse_decode.argtypes = [p, i64, p, p, p, p, i, i, i, p, p, p, p, p, p, p]
            cdll.zp_rep_totals.restype = i
            cdll.zp_rep_totals.argtypes = [p, p, p, p, i, p, p, p, p]
            cdll.zp_rep_apply.restype = i
            cdll.zp_rep_apply.argtypes = [p, p, p, p, i, p, p, p]
            cdll.zp_zstd_stitch.restype = i
            cdll.zp_zstd_stitch.argtypes = [p, i, p, i, p, p, p, p, i, p, i, p, p, p, i64, i64,
                                            p, p, p, p, p]
            cdll.zp_zstd_layout.restype = i
            cdll.zp_zstd_layout.argtypes = [p, i, p, p, p, p, p, p, p, p, i64, p, i64, p, i, p,
                                            p, p, p]
            cdll.zp_zstd_trim.restype = i
            cdll.zp_zstd_trim.argtypes = [p, i64, p, i, i64, p, p, i, p, p]
            cdll.zp_zstd_chain.restype = i
            cdll.zp_zstd_chain.argtypes = [p, i, p, p, p, p, p, p, p, p]
            cdll.zp_error_string.restype = ctypes.c_char_p
            cdll.zp_error_string.argtypes = [i]
            _LIB = cdll
        return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if rc != 0:
        msg = lib().zp_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
