"""The matrix products' least time on the card (the larger of their
FLOPs at the dtype's peak and their bytes at the HBM rate; the entry
counts both for the window with ``flops/<subject>.py``) over the device
time of the GEMM kernels that computed them (the port's ``lapis_gemm*``
or cuBLAS's, by ``portbench/kinds.py``)."""
from portbench import kinds


def read(run):
    d = run.data
    peak = (run.peak or {}).get("flops", {}).get(d.get("dtype"))
    if not peak or not d.get("product_flops"):
        return None
    spent = run.trace.kernel_s(kinds.gemm)
    if spent <= 0:
        return None
    bound = max(d["product_flops"] / peak,
                d["product_bytes"] / run.peak["hbm_bytes_s"])
    return 100.0 * bound / spent
