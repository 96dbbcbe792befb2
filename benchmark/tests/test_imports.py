"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(before the first dot) is compared whole, since the port's name begins
with the JAX package's."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dctz_tpu"}


def _top_level_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not (_top_level_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "dctz_tpu_torch" not in _top_level_imports(path), path
    # the top-level comparison is whole: the port's own name passes the
    # JAX check above
    assert "dctz_tpu_torch".split(".")[0] not in FORBIDDEN
