"""The window's model FLOPs (``data["flops"]``, which the entry counts
with ``flops/<subject>.py``) over the window, as a share of the card's
dense peak in the dtype the work is computed in (``data["dtype"]``)."""


def read(run):
    peak = (run.peak or {}).get("flops", {}).get(run.data.get("dtype"))
    if not peak or not run.data.get("flops"):
        return None
    return 100.0 * run.data["flops"] / run.window_s / peak
