"""zpack CLI — all 8 commands of the reference CLI
(parity: programs/zpack_cli.c:16-39 for the surface, programs/commands.c for
per-command behavior, programs/args.c for switches).

Usage: zpack <command> [<switches>...] <archive> [<files>...]

Commands: c create · a add · e extract flat · x extract full paths ·
l list · d delete · m move · t test.
Switches: -m method:level (default zstd:3) · -o outdir · -x exclude ·
--unsafe · -h/--help · --device cuda|cpu (default cuda).

``--device`` names the device of the codecs' device routes: ``c`` and ``a``
compress LZ4 entries of 64 KiB or more on it.  ``x`` and ``t`` stream LZ4
and zstd entries through the host decoders by design, as they do in the JAX
package; the device route for reading an entry is ``Reader.read_file``,
which replays LZ4 and decodes zstd on the device.  ``--device cuda`` without
a GPU exits with an error and never carries on on the CPU.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from .. import constants as C
from .. import engine
from ..codecs import device as codec_device, device_setting, set_device
from ..errors import ZPackError
from ..reader import Reader
from ..stream import read_file_stream_iter
from ..writer import CompressOptions, Writer
from . import paths as P

PROGRAM_NAME = "zpack-tpu command line interface"
VERSION = "0.1.0"


def print_help(out=None):
    (out or sys.stdout).write(
        f"{PROGRAM_NAME} v{VERSION}\n"
        "Usage: zpack <command> [<switches>...] <archive> [<files>...]\n"
        "\n"
        "Commands\n"
        "    c: create archive\n"
        "    a: add files to archive\n"
        "    e: extract files from archive (without directories)\n"
        "    x: extract files with full paths\n"
        "    l: list files in archive\n"
        "    d: delete files from archive\n"
        "    m: move files in archive\n"
        "    t: test integrity of files in archive\n"
        "    train-dict: train a shared zstd dictionary from sample files\n"
        "                (zpack train-dict <out.dict> <files>...)\n"
        "\n"
        "Switches\n"
        "    -m <param>: set compression method (method:level, default zstd:3)\n"
        "    -D <file>: compress zstd entries against a shared dictionary\n"
        "               (create/add; stored in-archive as __zpack.dict)\n"
        "    --dict-size <bytes>: trained dictionary size (train-dict, default 16384)\n"
        "    -o <directory>: set output directory\n"
        "    -x <file>: exclude file from extraction\n"
        "    -h, --help: show this help message\n"
        "    --unsafe: allow files to be extracted outside of destination\n"
        "    --device <cuda|cpu>: device of the LZ4 and zstd device routes (default cuda)\n"
        "    --engine <native|python>: select the host compression engine\n"
        "    --metrics: print per-phase throughput counters to stderr on exit\n"
    )


@dataclass
class Options:
    """parity: args_options (programs/args.h:6-24)."""

    command: str = ""
    path_list: list[str] = field(default_factory=list)
    exclude_list: list[str] = field(default_factory=list)
    output: str = ""
    options: CompressOptions = field(default_factory=CompressOptions)
    unsafe: bool = False
    engine: str = ""
    device: str = "cuda"
    metrics: bool = False
    dict_path: str = ""
    dict_size: int = 16 << 10


_METHODS = {"none": C.CompressionMethod.NONE, "zstd": C.CompressionMethod.ZSTD,
            "lz4": C.CompressionMethod.LZ4}


def parse_args(argv: list[str]) -> Options | None:
    """parity: args_parse (programs/args.c:66-170); '-m method:level' with
    per-method level defaults (args.c:107-119)."""
    opts = Options()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            return None
        if a == "--unsafe":
            opts.unsafe = True
        elif a == "--metrics":
            opts.metrics = True
        elif a == "--engine":
            i += 1
            if i >= len(argv):
                print("Error: --engine requires a parameter (native|python)")
                return None
            opts.engine = argv[i]
        elif a == "--device":
            i += 1
            if i >= len(argv):
                print("Error: --device requires a parameter (cuda|cpu)")
                return None
            opts.device = argv[i]
        elif a == "-m":
            i += 1
            if i >= len(argv):
                print("Error: -m requires a parameter")
                return None
            spec = argv[i]
            if ":" in spec:
                mname, _, lvl = spec.partition(":")
            else:
                mname, lvl = spec, ""
            if mname not in _METHODS:
                print(f"Error: Invalid compression method: {mname}")
                return None
            method = _METHODS[mname]
            level = int(lvl) if lvl else None
            opts.options = CompressOptions(method, level)
        elif a in ("-D", "--dict"):
            i += 1
            if i >= len(argv):
                print("Error: -D requires a parameter")
                return None
            opts.dict_path = argv[i]
        elif a == "--dict-size":
            i += 1
            if i >= len(argv):
                print("Error: --dict-size requires a parameter")
                return None
            try:
                opts.dict_size = int(argv[i])
            except ValueError:
                print(f"Error: invalid dictionary size: {argv[i]}")
                return None
        elif a == "-o":
            i += 1
            if i >= len(argv):
                print("Error: -o requires a parameter")
                return None
            opts.output = argv[i]
        elif a == "-x":
            i += 1
            if i >= len(argv):
                print("Error: -x requires a parameter")
                return None
            opts.exclude_list.append(argv[i])
        elif not opts.command:
            opts.command = a
        else:
            opts.path_list.append(a)
        i += 1
    if not opts.command or not opts.path_list:
        return None
    return opts


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------


def _write_files_streaming(writer: Writer, files: list[tuple[str, str]], opts: Options) -> int:
    """parity: write_files (programs/commands.c:56-168): per-file chunked
    read + streaming compress, printing each name.

    Small files accumulate into batches routed through the writer's native
    batch path (one FFI call compresses+hashes the whole group on worker
    threads); large files stream with bounded memory like the reference."""
    chunk = 128 << 10
    batch_limit = 64 << 20  # max bytes buffered for a batch
    # the device engine compresses whole entries (steps of blocks), so
    # one-shot even large files instead of the host streaming compressor
    device_engine = codec_device() is not None
    oneshot_limit = (256 << 20) if device_engine else (1 << 20)
    pending: list[tuple[str, bytes]] = []
    pending_bytes = 0

    def flush_batch():
        nonlocal pending, pending_bytes
        if pending:
            writer.write_files([(n, d, opts.options) for n, d in pending])
            pending = []
            pending_bytes = 0

    for fs_path, arc_name in files:
        print(f"  {arc_name}")
        try:
            small = os.path.getsize(fs_path) <= oneshot_limit
        except OSError:
            small = False
        if small:
            with open(fs_path, "rb") as f:
                data = f.read()
            pending.append((arc_name, data))
            pending_bytes += len(data)
            if pending_bytes >= batch_limit:
                flush_batch()
            continue
        flush_batch()  # keep archive entry order
        writer.write_file_stream_begin(arc_name, opts.options)
        with open(fs_path, "rb") as f:
            while True:
                data = f.read(chunk)
                if not data:
                    break
                writer.write_file_stream(data)
        writer.write_file_stream_end()
    flush_batch()
    return 0


def _report_ratio(writer: Writer) -> None:
    """parity: write_end's ratio report (programs/commands.c:189-192)."""
    uncomp = sum(e.uncomp_size for e in writer.file_entries)
    comp = sum(e.comp_size for e in writer.file_entries)
    ratio = (comp / uncomp * 100) if uncomp else 100.0
    print(f"-- Done. Archive size: {writer.file_size} bytes ({ratio:.2f}%)")


def _maybe_set_dictionary(w, opts: Options, existing_names=None) -> bool:
    """Apply -D: attach a shared zstd dictionary to the writer (extension;
    the reference CLI has no dictionary switches)."""
    if not opts.dict_path:
        return True
    if existing_names and C.DICT_ENTRY_NAME in existing_names:
        print("Error: archive already contains a shared dictionary "
              f"({C.DICT_ENTRY_NAME}); cannot attach another")
        return False
    try:
        with open(opts.dict_path, "rb") as f:
            w.set_dictionary(f.read())
    except OSError as e:
        print(f"Error: cannot read dictionary {opts.dict_path}: {e}")
        return False
    return True


def command_train_dict(opts: Options) -> int:
    """Train a shared zstd dictionary from sample files (extension):
    zpack train-dict <out.dict> <files/dirs>... [--dict-size N]"""
    out_path = opts.path_list[0]
    try:
        files = P.walk_files(opts.path_list[1:])
    except FileNotFoundError as e:
        print(f"Error: File not found: {e.args[0]}")
        return 1
    samples = []
    for path, _name in files:
        try:
            with open(path, "rb") as f:
                samples.append(f.read(4 << 20))
        except OSError:
            pass
    if not samples:
        print("Error: no sample files")
        return 1
    from ..codecs.zstd.dict import train_dictionary

    blob = train_dictionary(samples, opts.dict_size)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"-- Trained dictionary: {out_path} ({len(blob)} bytes from "
          f"{len(samples)} samples)")
    return 0


def command_create(opts: Options) -> int:
    """parity: command_create (programs/commands.c:198-247)."""
    archive_path = opts.path_list[0]
    try:
        files = P.walk_files(opts.path_list[1:])
    except FileNotFoundError as e:
        print(f"Error: File not found: {e.args[0]}")
        return 1
    # refuse to archive the archive itself (commands.c:113-119)
    arc_abs = os.path.abspath(archive_path)
    files = [(p, n) for p, n in files if os.path.abspath(p) != arc_abs]
    print(f"-- Creating archive: {archive_path}")
    try:
        with Writer.open(archive_path) as w:
            w.write_header()
            w.write_data_header()
            if not _maybe_set_dictionary(w, opts):
                return 1
            print("-- Adding files...")
            _write_files_streaming(w, files, opts)
            w.write_cdr()
            w.write_eocdr()
            _report_ratio(w)
    except ZPackError as e:
        print(f"Error: {e} (code {e.code})")
        return 1
    return 0


def command_add(opts: Options) -> int:
    """parity: command_add (programs/commands.c:249-300) — copy existing
    entries raw into a temp archive, append new files, replace."""
    archive_path = opts.path_list[0]
    try:
        files = P.walk_files(opts.path_list[1:])
    except FileNotFoundError as e:
        print(f"Error: File not found: {e.args[0]}")
        return 1
    tmp = P.tmp_archive_path(archive_path)
    try:
        reader = Reader.open(archive_path)
    except ZPackError as e:
        print(f'Error: Failed to open "{archive_path}" for reading (code {e.code})')
        return 1
    existing = {e.filename for e in reader.file_entries}
    files = [(p, n) for p, n in files if n not in existing]
    print(f"-- Adding files to archive: {archive_path}")
    try:
        with Writer.open(tmp) as w:
            w.write_header()
            w.write_data_header()
            w.write_files_from_archive(reader, reader.file_entries)
            if not _maybe_set_dictionary(w, opts, existing_names=existing):
                os.unlink(tmp)
                return 1
            print("-- Adding files...")
            _write_files_streaming(w, files, opts)
            w.write_cdr()
            w.write_eocdr()
            _report_ratio(w)
    except ZPackError as e:
        print(f"Error: {e} (code {e.code})")
        os.unlink(tmp)
        return 1
    finally:
        reader.close()
    P.replace_file(tmp, archive_path)
    return 0


def _extract(opts: Options, full_path: bool) -> int:
    """parity: extract_files_i (programs/commands.c:413-492) + extract_file
    (:326-411): streaming decode, exclude filter, path sanitize, mkdir -p,
    continue past per-file errors while counting them."""
    archive_path = opts.path_list[0]
    only = set(opts.path_list[1:])
    print(f"-- Reading archive: {archive_path}")
    try:
        # memory-backed when the archive fits: thread-safe parallel decode
        if os.path.getsize(archive_path) <= (512 << 20):
            with open(archive_path, "rb") as f:
                reader = Reader.from_memory(f.read(), shared=True)
        else:
            reader = Reader.open(archive_path)
    except (ZPackError, OSError) as e:
        code = getattr(e, "code", "io")
        print(f'Error: Failed to open "{archive_path}" for reading (code {code})')
        return 1
    out_dir = opts.output or "."
    errors = 0
    extracted = 0
    print("-- Extracting files...")
    jobs = []
    for entry in reader.file_entries:
        if only and entry.filename not in only:
            continue
        if entry.filename in opts.exclude_list:
            continue
        # the shared dictionary is archive metadata, not user content —
        # extract it only when explicitly named
        if entry.filename == C.DICT_ENTRY_NAME and not only:
            continue
        name = entry.filename
        if not full_path:
            name = name.rsplit("/", 1)[-1]
        if not opts.unsafe:
            name = P.process_path(name)
        if not name:
            continue
        jobs.append((entry, os.path.join(out_dir, name)))

    def extract_one(entry, dest):
        P.mkdir_p(os.path.dirname(dest))
        with open(dest, "wb") as f:
            for chunk in read_file_stream_iter(reader, entry):
                f.write(chunk)

    # Small entries of memory-backed archives decode through the native
    # batch path (one FFI call, worker threads, XXH3 verified inside);
    # large entries stream with bounded memory like the reference.
    group: list[tuple] = []
    group_bytes = 0

    def flush_group():
        nonlocal group, group_bytes, extracted, errors
        if not group:
            return
        outs = None
        try:
            outs = reader.read_files([e for e, _ in group])
        except (ZPackError, OSError):
            pass  # isolate the bad entry below
        for i, (entry, dest) in enumerate(group):
            print(f"  {entry.filename}")
            try:
                data = outs[i] if outs is not None else reader.read_file(entry)
                P.mkdir_p(os.path.dirname(dest))
                with open(dest, "wb") as f:
                    f.write(data)
                extracted += 1
            except (ZPackError, OSError) as e:
                print(f"Error: Failed to extract {entry.filename}: {e}")
                errors += 1
        group = []
        group_bytes = 0

    batchable = len(jobs) > 8 and hasattr(reader._source, "buf")
    for entry, dest in jobs:
        if batchable and entry.uncomp_size <= (1 << 20):
            group.append((entry, dest))
            group_bytes += entry.uncomp_size
            if group_bytes >= (128 << 20):
                flush_group()
            continue
        flush_group()
        print(f"  {entry.filename}")
        try:
            extract_one(entry, dest)
            extracted += 1
        except (ZPackError, OSError) as e:
            print(f"Error: Failed to extract {entry.filename}: {e}")
            errors += 1
    flush_group()
    reader.close()
    print(f"-- Done. {extracted} files extracted, {errors} errors.")
    return 1 if errors else 0


def command_extract(opts: Options) -> int:
    return _extract(opts, full_path=False)


def command_extract_full(opts: Options) -> int:
    return _extract(opts, full_path=True)


_METHOD_NAMES = {0: "none", 1: "zstd", 2: "lz4"}


def command_list(opts: Options) -> int:
    """parity: command_list (programs/commands.c:501-548) — size/method
    table with totals row."""
    archive_path = opts.path_list[0]
    print(f"-- Reading archive: {archive_path}")
    try:
        reader = Reader.open(archive_path)
    except ZPackError as e:
        print(f'Error: Failed to open "{archive_path}" for reading (code {e.code})')
        return 1
    sep = "------------ ------------ --------  ------------------------"
    print(f"{'Size':>12} {'Compressed':>12} {'Method':>8}  Name")
    print(sep)
    for e in reader.file_entries:
        method = _METHOD_NAMES.get(e.comp_method, "?")
        print(f"{e.uncomp_size:>12} {e.comp_size:>12} {method:>8}  {e.filename}")
    print(sep)
    print(f"{reader.uncomp_size:>12} {reader.comp_size:>12} {'':>8}  {reader.file_count} files")
    reader.close()
    return 0


def _rewrite_archive(opts: Options, transform) -> int:
    """Shared rewrite-to-temp flow for delete/move
    (parity: open_archive_rw + utils_move, programs/commands.c:550-705)."""
    archive_path = opts.path_list[0]
    try:
        reader = Reader.open(archive_path)
    except ZPackError as e:
        print(f'Error: Failed to open "{archive_path}" for reading (code {e.code})')
        return 1
    tmp = P.tmp_archive_path(archive_path)
    try:
        with Writer.open(tmp) as w:
            w.write_header()
            w.write_data_header()
            transform(reader, w)
            w.write_cdr()
            w.write_eocdr()
    except ZPackError as e:
        print(f"Error: {e} (code {e.code})")
        os.unlink(tmp)
        return 1
    finally:
        reader.close()
    P.replace_file(tmp, archive_path)
    print("-- Done.")
    return 0


def command_delete(opts: Options) -> int:
    """parity: command_delete (programs/commands.c:550-620)."""
    targets = set(opts.path_list[1:])
    deleted = []

    def transform(reader, w):
        print("-- Deleting files...")
        keep = []
        for e in reader.file_entries:
            if e.filename in targets:
                print(f"  {e.filename}")
                deleted.append(e.filename)
            else:
                keep.append(e)
        w.write_files_from_archive(reader, keep)

    ret = _rewrite_archive(opts, transform)
    if ret == 0 and not deleted:
        print("Warning: No files were deleted")
    return ret


def command_move(opts: Options) -> int:
    """parity: command_move (programs/commands.c:622-705) — pairs of
    (source, destination) names."""
    if len(opts.path_list) % 2 == 0:
        print("Error: Insufficient destination to source count")
        return 1
    pairs = opts.path_list[1:]
    mapping = {pairs[i]: pairs[i + 1] for i in range(0, len(pairs), 2)}
    moved = []

    def transform(reader, w):
        print("-- Moving files...")
        for e in reader.file_entries:
            if e.filename in mapping:
                print(f"  {e.filename} -> {mapping[e.filename]}")
                moved.append(e.filename)
                e.filename = mapping[e.filename]
            w.write_files_from_archive(reader, [e])

    ret = _rewrite_archive(opts, transform)
    if ret == 0 and not moved:
        print("Warning: No files were moved")
    return ret


def command_test(opts: Options) -> int:
    """parity: command_test (programs/commands.c:706-773) — decode every
    entry, count hash mismatches/errors."""
    archive_path = opts.path_list[0]
    print(f"-- Reading archive: {archive_path}")
    try:
        # memory-backed when it fits: small entries verify through the
        # native batch path (parallel decompress + XXH3 inside one call)
        if os.path.getsize(archive_path) <= (512 << 20):
            with open(archive_path, "rb") as f:
                reader = Reader.from_memory(f.read(), shared=True)
        else:
            reader = Reader.open(archive_path)
    except (ZPackError, OSError) as e:
        code = getattr(e, "code", "io")
        print(f'Error: Failed to open "{archive_path}" for reading (code {code})')
        return 1
    print("-- Testing files...")
    failed = 0

    def verify_streaming(entry) -> bool:
        try:
            for _ in read_file_stream_iter(reader, entry):
                pass
            return True
        except ZPackError:
            return False

    batchable = (len(reader.file_entries) > 8 and hasattr(reader._source, "buf"))
    # zstd entries of dict-bearing archives may reference the shared
    # dictionary, which the native batch codec doesn't know — streaming
    # verify (dict-aware) handles them instead
    has_dict = any(e.filename == C.DICT_ENTRY_NAME for e in reader.file_entries)
    small = [e for e in reader.file_entries
             if e.uncomp_size <= (1 << 20) and not (has_dict and e.comp_method == 1)]
    ok_map = {}
    if batchable and len(small) > 8 and all(
        e.comp_method in (0, 1, 2)
        and e.offset + e.comp_size <= reader.file_size
        and (not e.comp_size or e.uncomp_size <= e.comp_size * 1_000_000 + (1 << 20))
        for e in small
    ):
        from .. import native

        # Capped groups: many entries each claiming up to 1 MiB must not sum
        # into one giant output allocation; MemoryError (a crafted CDR can
        # still claim ~128 MiB at once) falls back to streaming verify.
        OUT_CAP = 128 << 20
        buf = bytes(reader._source.buf)
        group: list = []
        group_out = 0
        def run_group(g):
            try:
                return native.decompress_batch(
                    buf,
                    [e.offset for e in g],
                    [e.comp_size for e in g],
                    [e.comp_method for e in g],
                    [e.uncomp_size for e in g],
                    [e.hash for e in g],
                )
            except (ZPackError, MemoryError):
                return None
        for e in small + [None]:
            if group and (e is None or group_out + e.uncomp_size > OUT_CAP):
                res = run_group(group)
                if res is not None:
                    _, mask = res
                    ok_map.update({id(ge): not m for ge, m in zip(group, mask)})
                group, group_out = [], 0
            if e is not None:
                group.append(e)
                group_out += e.uncomp_size
    for entry in reader.file_entries:
        ok = ok_map[id(entry)] if id(entry) in ok_map else verify_streaming(entry)
        if ok:
            print(f"  OK: {entry.filename}")
        else:
            print(f"  FAILED: {entry.filename}")
            failed += 1
    reader.close()
    if failed:
        print(f"-- Done. {failed} file(s) are corrupted.")
        return 1
    print("-- Done. All files OK.")
    return 0


_COMMANDS = {
    "c": command_create,
    "a": command_add,
    "e": command_extract,
    "x": command_extract_full,
    "l": command_list,
    "d": command_delete,
    "m": command_move,
    "t": command_test,
    "train-dict": command_train_dict,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if opts is None:
        print_help()
        return 1
    if opts.engine:
        import os

        if opts.engine == "python":
            os.environ["ZPACK_TPU_NO_NATIVE"] = "1"
        elif opts.engine != "native":
            print(f"Error: unknown engine {opts.engine}")
            return 1
    handler = _COMMANDS.get(opts.command)
    if handler is None:
        print(f"Invalid command: {opts.command}")
        print_help()
        return 1
    before = device_setting()
    try:
        engine.install(opts.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        return handler(opts)
    except BrokenPipeError:
        # downstream pager/head closed the pipe: not an archive error
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    finally:
        set_device(before)
        if opts.metrics:
            from ..utils.observe import metrics

            sys.stderr.write(metrics.report() + "\n")


if __name__ == "__main__":
    raise SystemExit(main())
