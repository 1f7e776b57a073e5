"""The card's idle ms a step in gaps whose midpoint falls inside the
program's ``train.step`` span on the host: the program starving the
card.  The rest of ``idle_pct.train`` is the benchmark's own loop
between steps (``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.step_idle_ms(run)
