"""The benchmark's own CPU tests: the repository root and the port's
sources on the import path, so ``portbench`` and ``repro_torch`` import
as they do under ``portbench/run.py``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
