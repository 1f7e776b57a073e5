"""Kernel names by kind, as the card's trace names them: the GEMMs
(cuBLAS's and the port's ``lapis_gemm*``), attention (the port's flash
and decode kernels, or a library's), and the port's hand kernels (every
``lapis_*``)."""


def gemm(name: str) -> bool:
    n = name.lower()
    return "gemm" in n or n.startswith("nvjet") or "xmma" in n


def attention(name: str) -> bool:
    n = name.lower()
    return "flash" in n or "attention" in n or "fmha" in n


def hand(name: str) -> bool:
    return name.startswith("lapis_")


def elementwise(name: str) -> bool:
    """Neither a GEMM, nor attention, nor a hand kernel: the unfused
    elementwise and reduction passes."""
    return not (gemm(name) or attention(name) or hand(name))
