"""Device ms a step in kernels launched inside the paged decode's
``attn.decode`` span (the paged append, the page gather and the
decode-attention kernel) (``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.kernel_ms(run, "attn.decode")
