"""zpack-tpu on PyTorch and CUDA.

The port of ``zpack_tpu`` to PyTorch, with hand-written CUDA kernels for
Hopper.  The package stands alone: it imports ``torch`` and numpy, never
``jax``, and nothing of the JAX package.  Its host layers are its own copies
of the JAX package's, under the same relative names, so each module's
counterpart is found by path.

Layout:

* host layers (copies): ``constants``, ``errors``, ``format/records``,
  ``reader``, ``writer``, ``stream``, ``native`` (builds the C++ under the
  repository's ``native/`` into ``_build/``), ``codecs/`` (the registry,
  ``xxh3``, ``match``, ``lz4/{block,frame}``,
  ``zstd/{bits,fse,huffman,seq,frame,encode,dict}``), ``parallel/host``,
  ``utils/observe`` (``trace`` on ``torch.profiler``), ``cli/``;
* ``codecs/lz4/__init__.py``, ``codecs/zstd/__init__.py``: the codecs, with
  device routes where the JAX package has its ``ZPACK_TPU_ENGINE=tpu``
  branches; the routes run on the GPU unless ``engine.install(device)``
  names another device or ``engine.uninstall()`` turns them off;
* ``kernels/lz4_torch.py``: the LZ4 match finder (with its wire-format
  epilogues and size estimate) and the sequence replay, each a plain PyTorch
  version plus a wrapper over its CUDA kernel; likewise
  ``kernels/xxh3_torch.py`` (XXH3-64), ``kernels/huffman_torch.py`` and
  ``kernels/fse_torch.py`` (the zstd literal and sequence coders);
* ``kernels/_build.py``: builds ``csrc/*.cu`` with nvcc at first use;
* ``parallel/pipeline.py``: ``DeviceCompressor``, LZ4 and zstd frames (plain
  and shared-dictionary) from the device tokenizer;
* ``parallel/extract.py``: the batched LZ4 replay and the zstd device decode;
* ``cli/main.py``: ``python -m zpack_tpu_torch ... --device cuda|cpu``.
"""

from .constants import ARCHIVE_VERSION, CompressionMethod
from .errors import Result, ZPackError
from .format.records import FileEntry
from .reader import Reader
from .stream import ZPackStream, init_stream, read_file_stream, read_stream_done
from .writer import CompressOptions, Writer, write_archive_to_bytes

__version__ = "0.1.0"

__all__ = [
    "ARCHIVE_VERSION",
    "CompressionMethod",
    "CompressOptions",
    "FileEntry",
    "Reader",
    "Result",
    "Writer",
    "ZPackError",
    "ZPackStream",
    "init_stream",
    "read_file_stream",
    "read_stream_done",
    "write_archive_to_bytes",
    "__version__",
]
