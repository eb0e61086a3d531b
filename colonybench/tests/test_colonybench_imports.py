"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``repro_torch`` begins with ``repro`` and is not it."""

from __future__ import annotations

import ast

import pytest

from colonybench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(harness.HERE)) for p in FILES])
def test_no_jax_or_repro(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_takes_nothing_from_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path
    # the strings of the broker's source, run with ``-c``, too
    from colonybench import broker

    assert not {line.split()[1].split(".")[0] for line in broker.SOURCE.splitlines()
                if line.startswith(("import ", "from "))} & FORBIDDEN


def test_whole_name_comparison():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN
