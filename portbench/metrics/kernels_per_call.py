"""Device kernels a compiled call launches, from the trace (copies and
sets not counted)."""


def read(run):
    n = run.trace.kernel_count()
    calls = run.data.get("calls")
    return n / calls if n and calls else None
