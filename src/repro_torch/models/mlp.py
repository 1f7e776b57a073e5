"""The gated feed-forward block (SwiGLU / GeGLU) on ``core.ops``: the
reference's ``models/mlp.py:apply_gated_mlp``, traceable by the port's
compiler.  Weights must already be in the activation dtype (the
reference casts them inside the block; the tracer would record that as
a ``tensor.cast``)."""
from __future__ import annotations

from repro_torch.core import ops

_ACTS = {"silu": ops.silu, "gelu": ops.gelu}


def apply_gated_mlp(p: dict, x, act: str = "silu"):
    g = _ACTS[act](ops.matmul(x, p["w_gate"]))
    u = ops.matmul(x, p["w_up"])
    return ops.matmul(ops.mul(g, u), p["w_down"])


def gated_mlp_block(p: dict, x, act: str = "silu"):
    """The block with its residual add: ``x + mlp(x)``."""
    return ops.add(apply_gated_mlp(p, x, act), x)
