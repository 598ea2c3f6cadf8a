"""The import boundary: nothing the harness runs imports JAX, Flax or the
JAX package, and the reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark.run import FOREIGN, foreign_modules

BENCH = Path(__file__).resolve().parents[1]


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            out.add(n.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_foreign_imports(path):
    assert not imports(path) & set(FOREIGN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "buffer_tpu_torch" not in imports(path)


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "buffer_tpu_torch_fake", object())
    assert "buffer_tpu" not in foreign_modules()
    monkeypatch.setitem(sys.modules, "buffer_tpu.core", object())
    assert foreign_modules() == ["buffer_tpu"]
