"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
references import nothing of the port."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
SOURCES = sorted(PB.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "math", "torch",
                                       "portbench"}


def test_forbidden_modules_compare_whole_names():
    from portbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "reproducible"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]
