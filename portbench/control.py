"""Readings from which a cell's limits are set, on the card, at the
cell's own size, for many seeds in one process:

  python3 portbench/control.py --workload <cell> --seconds 2 \
      --seeds 11 12 13 [--fault <kind>]

For each seed one run of the cell with a short window: the numbers the
program reads against the reference (its sound runs, or with ``--fault``
a fault planted under the timed path, ``faults.py``), and the same
numbers read by the reference in fp8 put in the program's place (the
control).  The last line gives, for each number, the largest reading of
the program and the smallest of the control.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    entry = harness.load_json(
        harness.PB / "traffic" /
        f"{harness.cell_entry(harness.benchmark(), args.workload)['traffic']}"
        ".json")["entry"]
    prog, ctrl = {}, {}
    for seed in args.seeds:
        plant = faults.planted(entry, args.fault) if args.fault \
            else contextlib.nullcontext()
        with plant:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 control=True)
        read = {k: c["value"] for k, c in r["checks"].items()}
        low = r["counters"]["control"]
        print(json.dumps({"seed": seed, "program": read, "control": low,
                          "counters": {k: v for k, v in r["counters"].items()
                                       if k != "control"}}), flush=True)
        for k, v in read.items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in low.items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "seeds": len(args.seeds), "program_max": prog,
                      "control_min": ctrl}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
