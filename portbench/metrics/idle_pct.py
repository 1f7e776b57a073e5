"""Share of the window in which nothing ran on the card: 100 less the
union of the trace's device intervals over the window.  Every cell has
it; ``idle_pct.<kind>`` moves that kind's end-to-end metric."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
