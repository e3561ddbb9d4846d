"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either (module names compared
whole, before the first dot: the port's name begins with the JAX
package's)."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "slam_process_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PKG)) for p in FILES])
def test_no_jax_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path.relative_to(PKG)} imports {found}"
    if "reference" in path.relative_to(PKG).parts:
        assert "slam_process_tpu_torch" not in set(_imports(path))


def test_walk_sees_every_kind_of_file():
    names = {p.relative_to(PKG).parts[0] for p in FILES}
    assert {"reference", "drivers", "metrics", "counts", "traffic", "run.py"} <= names
