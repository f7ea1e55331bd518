"""What the benchmark imports: nothing of JAX, Flax or the JAX package
``repro`` anywhere under ``bench/`` (top-level module names compared
whole: ``repro_torch`` is the port), nothing of the port in the reference,
and nothing read from the JAX package's ``benchmarks/``."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in _top_level_imports(path)
    assert "repro_torch" not in path.read_text()


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        assert not any("benchmarks/" in s or s == "benchmarks" for s in strings), path


def test_the_whole_word_rule():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
