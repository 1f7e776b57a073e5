"""Device ms a step in kernels launched inside the training step's
``train.forward`` span (the compute cast of the master and the loss) and
in no span nested in it (``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.kernel_ms(run, "train.forward")
