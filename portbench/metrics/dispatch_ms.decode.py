"""Device ms a step in kernels launched inside the MoE's ``moe.route``
(router, softmax, top-k, slot assignment, scatter into the buffers) and
``moe.combine`` (the gated gather back) spans
(``portbench/progspans.py``)."""
from portbench import progspans


def read(run):
    route = progspans.kernel_ms(run, "moe.route")
    combine = progspans.kernel_ms(run, "moe.combine")
    if route is None or combine is None:
        return None
    return route + combine
