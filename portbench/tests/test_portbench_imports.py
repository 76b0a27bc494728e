"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level module name, and the reference imports nothing of the
port."""
import ast
import sys
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "math", "dataclasses", "numpy",
                                       "torch", "portbench"}
    text = path.read_text()
    assert "import icp_proposal" not in text and "from icp_proposal" not in text


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "icp_proposal_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "icp_proposal_tpu.ops", object())
    assert forbidden_modules() == ["icp_proposal_tpu"]
