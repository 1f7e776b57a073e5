"""The torch port stands alone: importing it pulls in neither JAX nor the
reference package, and its sources (and chip_smoke.py) import neither;
chip_smoke.py fails, printing no result, without a card or without the
rest of the repository."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))",
    re.M)


def _port_modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_import_pulls_in_neither_jax_nor_reference():
    mods = _port_modules()
    for serving in ("repro_torch.runtime.scheduler",
                    "repro_torch.models.serve", "repro_torch.models.model",
                    "repro_torch.models.attention",
                    "repro_torch.launch.serve", "repro_torch.launch.train",
                    "repro_torch.launch.steps", "repro_torch.optim",
                    "repro_torch.optim.optimizer", "repro_torch.data",
                    "repro_torch.data.pipeline", "repro_torch.checkpoint",
                    "repro_torch.checkpoint.manager",
                    "repro_torch.runtime.fault"):
        assert serving in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "raise SystemExit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repository(where, tmp_path):
    import torch
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("with a card the smoke runs for real")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout and '"kernels"' not in res.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_neither_jax_nor_reference(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path


def test_scan_catches_the_imports_it_forbids():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import numpy", "from repro.core import ir",
                 "    import repro.core.ir", "import repro"):
        assert _IMPORT.findall(line), line
    for line in ("import repro_torch", "from repro_torch.core import ir",
                 "# the reference's jax.jit is dropped"):
        assert not _IMPORT.findall(line), line
