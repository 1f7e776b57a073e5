"""Device ms a step in kernels that are neither GEMMs, nor attention,
nor the port's hand kernels (``portbench/kinds.py``): the unfused
elementwise passes (in training: AdamW's, the casts and the loss)."""
from portbench import kinds


def read(run):
    steps = run.data.get("steps")
    ms = 1e3 * run.trace.kernel_s(kinds.elementwise)
    return ms / steps if ms > 0 and steps else None
