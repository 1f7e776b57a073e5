"""The decode-attention kernel's least time a step, its bytes (each
slot's K and V read once, its queries read and its output written:
``flops/<config>.py``) at the HBM rate, over the device time of the
attention kernels (``portbench/kinds.py``) launched inside the paged
decode's ``attn.decode`` span."""
from portbench import kinds, progspans


def read(run):
    d = run.data
    j, steps = progspans.of_run(run), d.get("steps")
    hbm = (run.peak or {}).get("hbm_bytes_s")
    if not j or not j.kernel_ns["attn.decode"] or not steps or not hbm \
            or not d.get("attention_bytes"):
        return None
    spent = run.trace.kernel_s(kinds.attention) / steps
    if spent <= 0:
        return None
    return 100.0 * d["attention_bytes"] / hbm / spent
