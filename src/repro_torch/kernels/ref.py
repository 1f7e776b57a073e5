"""Plain torch versions of the kernels in this package (the reference's
``kernels/ref.py``, dense matmul part): the CPU path of each wrapper, the
oracle the kernels are held against on the card, and the library
(``torch``) registry implementations.  Mixed operand dtypes promote
first, as ``jnp.matmul`` does (``torch.matmul`` refuses them)."""
from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return matmul(a, x)
