"""Command line of the port: ``python -m zpack_tpu_torch <c|a|e|x|l|d|m|t> ...
[--device cuda|cpu]``.

The commands, options and archive format are those of ``zpack_tpu.cli``;
this wrapper takes ``--device`` off the arguments (default ``cuda``),
installs the port's engine on that device and hands the rest to
``zpack_tpu.cli.main.main``.  ``c`` and ``a`` compress LZ4 entries on the
device.  ``x`` and ``t`` stream LZ4 and zstd entries through the host
decoders by design, as they do in the JAX package; the device route for
reading an entry is ``Reader.read_file``, which replays LZ4 and decodes
zstd on the device.  ``--device cuda`` without a GPU exits with an error
and never carries on on the CPU.
"""

from __future__ import annotations

import sys

from zpack_tpu.cli import main as zmain

from .. import engine


def _pop_device(argv: list[str]) -> tuple[str, list[str]]:
    device = "cuda"
    rest: list[str] = []
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value (cuda or cpu)")
        else:
            rest.append(a)
    return device, rest


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        device, argv = _pop_device(argv)
        engine.install(device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        return zmain.main(argv)
    finally:
        engine.uninstall()


if __name__ == "__main__":
    raise SystemExit(main())
