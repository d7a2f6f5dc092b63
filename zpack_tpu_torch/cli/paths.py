"""CLI filesystem utilities.

Parity model: programs/utils.c — recursive directory walk (:350-414),
mkdir -p (:95-141), temp-archive naming (:477-500), atomic-ish replace
(utils_move, :143-158), and the path-traversal sanitizer
``utils_process_path`` (:526-590).
"""

from __future__ import annotations

import os
import pathlib


def process_path(path: str, windows: bool = os.name == "nt") -> str:
    """Sanitize an archive-stored path for extraction.

    Reimplements utils_process_path (programs/utils.c:526-590):
      * leading '/' stripped (no absolute extraction),
      * consecutive '/' collapsed,
      * '..' components neutralized (second dot dropped before a '/'),
      * on Windows flavor: drive-colon at index 1 → separator, '\\' → '_'.
    """
    out: list[str] = []
    got_first_dir = False
    got_sep = False
    dot_pos = 0
    n = len(path)
    for i, ch in enumerate(path):
        if ch != "/":
            got_sep = False
            if not got_first_dir:
                got_first_dir = True
        if ch != "." and dot_pos:
            dot_pos = 0
        if windows and ch == ":":
            if i == 1:
                out.append("/")
                got_sep = True
            continue
        if windows and ch == "\\":
            out.append("_")
            continue
        if ch == "/":
            if not got_sep:
                if not got_first_dir:
                    continue
                out.append("/")
                got_sep = True
            continue
        if ch == ".":
            dot_pos += 1
            if dot_pos == 2 and i + 1 < n and path[i + 1] == "/":
                continue
        out.append(ch)
    return "".join(out)


def walk_files(paths: list[str]) -> list[tuple[str, str]]:
    """Expand files/directories into (filesystem_path, archive_name) pairs.

    Parity: utils_prepare_file_list + the recursive walk
    (programs/utils.c:350-414,423-475) — directory arguments are walked
    recursively and archive names are relative to the argument's parent,
    with '/' separators; duplicate archive names are dropped
    (commands.c:103-112).
    """
    result: list[tuple[str, str]] = []
    seen: set[str] = set()
    for p in paths:
        p = p.rstrip("/")
        path = pathlib.Path(p)
        if path.is_dir():
            base = path.parent
            for sub in sorted(path.rglob("*")):
                if sub.is_file():
                    rel = sub.relative_to(base).as_posix()
                    if rel not in seen:
                        seen.add(rel)
                        result.append((str(sub), rel))
        elif path.is_file():
            name = path.name
            if name not in seen:
                seen.add(name)
                result.append((str(path), name))
        else:
            raise FileNotFoundError(p)
    return result


def mkdir_p(path: str) -> None:
    """parity: utils_mkdir_p (programs/utils.c:95-141)."""
    if path:
        os.makedirs(path, exist_ok=True)


def tmp_archive_path(archive_path: str) -> str:
    """Temp-file name next to the archive (parity: utils_get_tmp_path,
    programs/utils.c:477-500)."""
    for i in range(100000):
        cand = f"{archive_path}.tmp{i}"
        if not os.path.exists(cand):
            return cand
    raise FileExistsError("could not find free temp archive name")


def replace_file(tmp_path: str, dest_path: str) -> None:
    """parity: utils_move (programs/utils.c:143-158) — replace the original
    archive with the freshly written temp file."""
    os.replace(tmp_path, dest_path)
