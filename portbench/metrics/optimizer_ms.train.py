"""Device ms a step in kernels launched inside the training step's
``train.optimizer`` span (``opt_update``: the gradient cast and norm,
AdamW's passes, the new master) and in no span nested in it
(``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.kernel_ms(run, "train.optimizer")
