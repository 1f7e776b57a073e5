"""The program's own spans (``repro_torch.runtime.spans``, recorded while
the profiler runs) joined to the card's trace of the window.

A kernel belongs to the innermost span whose interval holds its launch
event (``Trace.launches``); an idle gap between the merged device
intervals belongs to the spans the host was in at the gap's midpoint.
Both match on time alone, whatever the thread: autograd's device thread
launches a backward's kernels while the calling thread waits inside
``train.backward``.  Only spans that overlap the window (its first
launch or kernel to its last kernel's end) count, so spans left by an
earlier run in the same process never do.  Where the trace holds no
device activity, or the program records no spans (a program without
``runtime/spans.py``), there is no join and the readers return None.

Run alone, it runs one cell traced and prints the join in full, with
the sums that tie it to the trace's own totals:

  python3 portbench/progspans.py --workload qwen2-1.5b.train-8x512 \\
      --seed 7 --seconds 30
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

STEP = "train.step"
NO_LAUNCH = "(no launch event)"     # a kernel whose launch was not traced
OUTSIDE = "(no span)"
_last = None                        # (trace, Join) of the latest window


@dataclasses.dataclass
class Join:
    kernel_ns: collections.Counter  # innermost span -> kernel ns
    idle_ns: collections.Counter    # innermost span at the gap -> gap ns
    step_idle_ns: int               # gaps inside a train.step span
    steps: int                      # train.step spans in the window


def _window(trace) -> tuple:
    starts = [trace.device[0][0]] + [t for t, _ in trace.launches.values()]
    return min(starts), max(e for _, e, _, _ in trace.device)


def _live(spans: list, times: list) -> list:
    """For each of the sorted ``times``, the spans that hold it, in the
    order they opened (the innermost last)."""
    order = sorted(spans, key=lambda s: s.start_ns)
    out, live, j = [], [], 0
    for t in times:
        while j < len(order) and order[j].start_ns <= t:
            live.append(order[j])
            j += 1
        live = [s for s in live if s.end_ns >= t]
        out.append(tuple(live))
    return out


def join(trace, spans: list) -> Optional[Join]:
    """The window's kernels and idle gaps put down to ``spans``."""
    if not trace.device:
        return None
    lo, hi = _window(trace)
    spans = [s for s in spans if s.end_ns >= lo and s.start_ns <= hi
             and s.end_ns >= s.start_ns]
    if not spans:
        return None
    kernel = collections.Counter()
    launched = sorted((trace.launches[c][0], e - s)
                      for s, e, _, c in trace.kernels if c in trace.launches)
    for (_, ns), live in zip(launched, _live(spans, [t for t, _ in launched])):
        kernel[live[-1].name if live else OUTSIDE] += ns
    kernel[NO_LAUNCH] += sum(e - s for s, e, _, c in trace.kernels
                             if c not in trace.launches)
    merged = trace._merged()
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    idle, in_step = collections.Counter(), 0
    for (a, b), live in zip(gaps, _live(spans, [(a + b) // 2
                                                for a, b in gaps])):
        idle[live[-1].name if live else OUTSIDE] += b - a
        if any(s.name == STEP for s in live):
            in_step += b - a
    return Join(kernel, idle, in_step,
                sum(1 for s in spans if s.name == STEP))


def of_run(run) -> Optional[Join]:
    """The join for a reader's view of a traced run, made once a window:
    the first reader takes the program's spans."""
    global _last
    if _last is not None and _last[0] is run.trace:
        return _last[1]
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    _last = (run.trace, join(run.trace, spans.take()))
    return _last[1]


def kernel_ms(run, name: str) -> Optional[float]:
    """Device ms a step in kernels launched inside ``name`` and in no
    span nested in it."""
    j, steps = of_run(run), run.data.get("steps")
    return j.kernel_ns[name] / 1e6 / steps if j and steps else None


def step_idle_ms(run) -> Optional[float]:
    j, steps = of_run(run), run.data.get("steps")
    return j.step_idle_ns / 1e6 / steps if j and steps else None


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(root), str(root / "src")]
    from portbench import harness, progspans
    from portbench.run import _fixed_caches
    _fixed_caches()
    result = harness.run_cell(args.workload, args.seed, args.seconds, True)
    # the readers ran the join in the imported module, not in __main__
    trace, j = progspans._last or (None, None)
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "metrics": result["metrics"], "device": result["device"]}
    if j is not None:
        steps = j.steps
        idle_ms = 1e3 * (trace.window_s - trace.busy_s) / steps
        out.update(
            steps=steps,
            kernel_ms={k: v / 1e6 / steps for k, v in j.kernel_ns.items()},
            kernel_ms_total=1e3 * trace.kernel_s(lambda n: True) / steps,
            busy_ms=1e3 * trace.busy_s / steps,
            idle_ms={k: v / 1e6 / steps for k, v in j.idle_ns.items()},
            step_idle_ms=j.step_idle_ns / 1e6 / steps,
            idle_ms_total=idle_ms,
            gaps_ms_total=sum(j.idle_ns.values()) / 1e6 / steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
