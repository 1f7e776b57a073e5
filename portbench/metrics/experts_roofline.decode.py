"""The expert products' least time a step on the card, the larger of
the routed tokens' FLOPs at the bf16 peak and every held expert's three
matrices read once at the HBM rate (``flops/<config>.py``), over the
device time of the kernels in ``moe.experts`` (``experts_ms.decode``).
The work counted is the tokens', not the padded slots', so less padding
reads as a larger share."""
from portbench import progspans


def read(run):
    d = run.data
    peak = (run.peak or {}).get("flops", {}).get(d.get("dtype"))
    ms = progspans.kernel_ms(run, "moe.experts")
    if not peak or not ms or not d.get("expert_flops"):
        return None
    bound_s = max(d["expert_flops"] / peak,
                  d["expert_bytes"] / run.peak["hbm_bytes_s"])
    return 100.0 * 1e3 * bound_s / ms
