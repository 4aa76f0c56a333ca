"""Nothing under ``portbench/`` imports JAX, Flax or the JAX package, and
nothing under ``portbench/reference/`` imports the port or climbs out of
the reference by a relative import. Names are compared whole, by the part
before the first dot."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "sparse_rcnn_tpu"}


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imports(path):
    """(top-level name, relative level) of every import in ``path``."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield None, node.level
            else:
                yield node.module.split(".")[0], 0
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0], 0


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_imports(path):
    rel = os.path.relpath(path, BENCH)
    in_ref = rel.startswith("reference" + os.sep)
    depth = rel.count(os.sep)        # packages between portbench/ and the file
    for name, level in imports(path):
        assert name not in FORBIDDEN, f"{rel} imports {name}"
        if in_ref:
            assert name not in ("sparse_rcnn_tpu_torch", "portbench"), f"{rel} imports {name}"
            # a relative import may not climb out of portbench/reference/
            assert level <= depth, f"{rel} climbs out of the reference"


def test_the_check_sees_a_forbidden_name():
    bad = "import jax.numpy as jnp\nfrom sparse_rcnn_tpu.ops import coords\n"
    tree = ast.parse(bad)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
             for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert names <= FORBIDDEN and names
    assert "sparse_rcnn_tpu_torch".split(".")[0] not in FORBIDDEN
