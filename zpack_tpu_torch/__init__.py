"""zpack-tpu on PyTorch and CUDA.

The port of ``zpack_tpu``'s device layers to PyTorch, with hand-written
CUDA kernels for Hopper.  It imports the JAX-free host layers of
``zpack_tpu`` (format, reader, writer, stream, codecs, native, cli) and
never imports jax.

Layout (each module mirrors its ``zpack_tpu`` counterpart):

* ``kernels/lz4_torch.py``: the LZ4 match finder and sequence replay, each
  a plain PyTorch version plus a wrapper over its CUDA kernel; likewise
  ``kernels/xxh3_torch.py`` (XXH3-64), ``kernels/huffman_torch.py`` and
  ``kernels/fse_torch.py`` (the zstd literal and sequence encoders);
* ``kernels/_build.py``: builds ``csrc/*.cu`` with nvcc at first use;
* ``parallel/pipeline.py``: ``DeviceCompressor``, LZ4 and zstd frames from
  the device tokenizer;
* ``parallel/extract.py``: ``decompress_lz4f_batched`` over the replay;
* ``codecs/``, ``engine.py``: the codecs and ``install(device)``, which
  routes ``zpack_tpu``'s Writer, Reader and CLI through the port;
* ``cli/main.py``: ``python -m zpack_tpu_torch ... --device cuda|cpu``.
"""
