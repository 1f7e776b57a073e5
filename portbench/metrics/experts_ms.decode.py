"""Device ms a step in kernels launched inside the MoE's ``moe.experts``
span (the three expert products over every slot of the buffers) and in
no span nested in it (``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.kernel_ms(run, "moe.experts")
