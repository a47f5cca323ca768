"""What the benchmark's modules import: never jax, jaxlib or the JAX
package (``repro``; ``repro_torch`` is another name), and in the
references nothing of the port either."""
import ast
from pathlib import Path

import pytest

from chipbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def _imported(path: Path) -> set:
    """Top-level module names a file imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert _imported(path) <= {"math", "torch", "chipbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("chipbench"):
            # the references read the benchmark's own inputs only
            assert node.module in ("chipbench.reference",
                                   "chipbench.traffic"), node.module


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    import jax.numpy as jnp\n"
                   "from repro.api import x\nimport repro_torch\n")
    assert _imported(bad) == {"jax", "repro", "repro_torch"}


def test_nothing_reads_the_old_benchmarks_folder():
    for path in FILES:
        if path.name == "test_chipbench_imports.py":
            continue
        assert "benchmarks/" not in path.read_text(), path
