"""Nothing under ``zbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``zpack_tpu_torch`` begins with ``zpack_tpu``."""

import ast

import pytest

from zbench.harness import FORBIDDEN, HERE

SOURCES = sorted(HERE.rglob("*.py"))
REFERENCE = sorted((HERE / "reference").rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imported(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imported(path)) & {"zpack_tpu_torch", "zpack_tpu", "jax", "torch"}


def test_whole_name_comparison():
    names = {"zpack_tpu_torch.codecs", "zpack_tpu_torch", "numpy"}
    assert not {n.split(".")[0] for n in names} & set(FORBIDDEN)
    assert {n.split(".")[0] for n in names | {"zpack_tpu.native"}} & set(FORBIDDEN)
