"""Nothing under kppbench/ imports JAX or the JAX package (whole
top-level names), and the reference imports nothing of the program."""

import ast
import os

import pytest

from kppbench import spec

BENCH = os.path.join(spec.ROOT, "kppbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "mckpp_tpu"}


def _modules():
    for d, _, files in os.walk(BENCH):
        if "_work" in d or "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in _modules() if os.sep + "reference" + os.sep in p),
    ids=os.path.basename)
def test_reference_imports_no_program(path):
    assert "mckpp_torch" not in set(_imports(path))
