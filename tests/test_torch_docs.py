"""The port's docs stay in step with the package.

The counterpart of the reference's ``tests/test_docs.py`` for
``docs/port.md`` and the README's port section: the stage table names
every module of ``repro_torch`` and every pass of the port's
``DEFAULT_PIPELINE``, every registered backend is documented, and no
relative link points at a path that does not exist.
"""
import fnmatch
import pathlib
import re

import pytest

from repro_torch.core import backend as backend_mod
from repro_torch.core import passmgr

REPO = pathlib.Path(__file__).parent.parent
PORT_MD = REPO / "docs" / "port.md"
PACKAGE = REPO / "src" / "repro_torch"

_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_CODE = re.compile(r"`([^`]+)`")

# frozen at collection time: a backend test registers a throwaway plugin
# backend at runtime that must not leak in
_BACKENDS = backend_mod.available_backends()


def _stage_rows() -> list:
    """(stage, reference, port, what changed) of the stage table."""
    text = PORT_MD.read_text()
    section = text.split("## Stages, module for module", 1)[1]
    section = section.split("\n## ", 1)[0]
    rows = []
    for line in section.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 4 and cells[0] not in ("stage", "---"):
            rows.append(tuple(cells))
    return rows


def _expand(spec: str) -> list:
    """``launch/{a,b}.py`` → ``launch/a.py``, ``launch/b.py``."""
    m = re.search(r"\{([^}]*)\}", spec)
    if not m:
        return [spec]
    return [x for part in m.group(1).split(",")
            for x in _expand(spec[:m.start()] + part + spec[m.end():])]


def _named_paths() -> list:
    """Every module path or pattern the stage table's port column names
    (``same names`` takes the reference column's)."""
    out = []
    for _, ref, port, _ in _stage_rows():
        cell = ref if port.startswith("same names") else port
        for code in _CODE.findall(cell):
            out += _expand(code)
    return out


def _modules() -> list:
    return sorted(str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
                  if p.name != "__init__.py")


def _covered(module: str, named: list) -> bool:
    return any(module == n or fnmatch.fnmatch(module, n)
               or (n.endswith("/") and module.startswith(n)) for n in named)


def test_stage_table_names_every_module():
    named = _named_paths()
    assert _stage_rows(), "no stage table in docs/port.md"
    missing = [m for m in _modules() if not _covered(m, named)]
    assert not missing, f"modules docs/port.md's stage table omits: {missing}"


def test_stage_table_names_only_modules_that_exist():
    mods = _modules()
    stale = [n for n in _named_paths()
             if n.endswith(".py") and "*" not in n
             and not (PACKAGE / n).exists() and n not in mods]
    assert not stale, f"stage table names missing port modules: {stale}"


def test_stage_table_names_every_default_pass():
    text = "\n".join(" ".join(r) for r in _stage_rows())
    for name in backend_mod.DEFAULT_PIPELINE:
        assert f"`{name}`" in text, name
    assert set(backend_mod.DEFAULT_PIPELINE) <= set(
        passmgr.registered_passes())


@pytest.mark.parametrize("name", _BACKENDS)
def test_every_backend_is_documented(name):
    assert f"`{name}`" in PORT_MD.read_text()
    assert f"`{name}`" in _readme_port_section()


def _readme_port_section() -> str:
    text = (REPO / "README.md").read_text()
    section = text.split("## The PyTorch + CUDA port", 1)[1]
    return section.split("\n## More", 1)[0]


@pytest.mark.parametrize("doc", ["docs/port.md", "README.md port section"])
def test_no_dead_relative_links(doc):
    if doc == "docs/port.md":
        base, text = PORT_MD.parent, PORT_MD.read_text()
    else:
        base, text = REPO, _readme_port_section()
    dead = []
    for target in _LINK.findall(text):
        if target.startswith(("http://", "https://", "mailto:", "#")):
            continue
        path = target.split("#", 1)[0]
        if path and not (base / path).exists():
            dead.append(target)
    assert not dead, f"dead relative links in {doc}: {dead}"


def test_readme_port_section_says_how_to_run_the_compiler_core_tests():
    text = _readme_port_section()
    assert "tests/test_torch_{analysis,passes,backend,costmodel,docs}.py" \
        in text
    assert "prefer_library" in text
