"""Spreads of repeated runs, and the bounds they allow:

  python3 portbench/spread.py runs.jsonl [more.jsonl ...]

Each line of the inputs is one run's result object with ``"cell"`` and
``"set"`` keys added (set ``A`` and ``B``: two sets of runs on the same
seeds; lines of other sets are left out).  A spread is the distance
from the first to the third quartile (``statistics.quantiles(values,
n=4)``) as a share of the median.  For each cell and end-to-end metric it
prints each set's median, spread, spread without the run farthest from
the median, and range (largest less smallest over the median); then the
spread of all the runs together and the gap between the sets' medians.
For each metric it prints the rule's bound, five times the widest
spread over the cells and never under 1%, beside the window that a
check of the same spreads allows: at least twice the mean of the sets'
spreads without their farthest runs, and at most eight times the widest
spread of all the runs (a bound of 1% is never too wide).
"""
from __future__ import annotations

import collections
import json
import statistics
import sys


def iqr_share(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def range_share(values) -> float:
    return (max(values) - min(values)) / statistics.median(values)


def main(paths) -> int:
    runs = collections.defaultdict(list)
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    if r["set"] not in ("A", "B"):
                        continue
                    for name, m in r["metrics"].items():
                        runs[(name, r["cell"], r["set"])].append(m["value"])
    cells = sorted({(n, c) for n, c, _ in runs})
    widest = collections.defaultdict(float)
    tight = collections.defaultdict(float)
    loose = collections.defaultdict(float)
    for name, cell in cells:
        a, b = runs[(name, cell, "A")], runs[(name, cell, "B")]
        for s, vals in (("A", a), ("B", b)):
            print(f"{name:12s} {cell:30s} {s}: n {len(vals)} median "
                  f"{statistics.median(vals)!r} spread "
                  f"{100 * iqr_share(vals):.3f}% without the farthest "
                  f"{100 * iqr_share(trimmed(vals)):.3f}% range "
                  f"{100 * range_share(vals):.3f}%")
        both = iqr_share(a + b)
        gap = abs(statistics.median(b) / statistics.median(a) - 1)
        print(f"{name:12s} {cell:30s} all {len(a + b)}: spread "
              f"{100 * both:.3f}% range {100 * range_share(a + b):.3f}% "
              f"medians apart {100 * gap:.3f}%")
        widest[name] = max(widest[name], iqr_share(a), iqr_share(b))
        tight[name] = max(tight[name], (iqr_share(trimmed(a)) +
                                        iqr_share(trimmed(b))) / 2)
        loose[name] = max(loose[name], iqr_share(a), iqr_share(b), both)
    for name in sorted(widest):
        print(f"{name:12s} widest spread {100 * widest[name]:.3f}% -> "
              f"rule {max(5 * widest[name], 0.01):.4f}; allowed "
              f"{2 * tight[name]:.4f} to {max(8 * loose[name], 0.01):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
