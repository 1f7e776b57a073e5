"""Device ms a step in kernels launched inside the training step's
``train.backward`` span (``torch.autograd.grad`` and the zero fill) and
in no span nested in it, whichever thread launched them
(``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    return progspans.kernel_ms(run, "train.backward")
