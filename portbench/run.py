"""Run one cell of BENCHMARK.json once, on the card this process sees.

  python3 portbench/run.py --workload qwen2-1.5b.mlp-compile-t4096 \
      --seed 7 --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and
``breakdown`` with ``--trace 1``); the numbers compared with the
reference, each beside its limit, come last there and as the last lines
of standard error.  Exits nonzero, printing no result, without a CUDA
card, with fewer cards than the cell asks for, or if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that a cell's later runs there find its kernels built (the port's
    nvcc libraries go to ``build/repro_torch/`` by themselves)."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["REPRO_TUNE_CACHE"] = str(cache / "repro-tune")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness
    chips = harness.cell_entry(harness.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
