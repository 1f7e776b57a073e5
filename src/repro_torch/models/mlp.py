"""Feed-forward blocks — the port of the reference's ``models/mlp.py``.

Two forms of the gated block (SwiGLU / GeGLU):

* :func:`apply_gated_mlp` / :func:`gated_mlp_block` are written on
  ``core.ops``, so the port's compiler traces them (each product becomes
  a ``kk.gemm``).  Weights must already be in the activation dtype (the
  reference casts them inside the block; the tracer would record that as
  a ``tensor.cast``).
* :func:`gated_mlp` and :func:`plain_mlp` are the eager tensor functions
  the serving layers call.  Their products stay ``torch.matmul``, as the
  reference leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.models.layers import activation
from repro_torch.models.spec import Spec

_ACTS = {"silu": ops.silu, "gelu": ops.gelu}


def apply_gated_mlp(p: dict, x, act: str = "silu"):
    g = _ACTS[act](ops.matmul(x, p["w_gate"]))
    u = ops.matmul(x, p["w_up"])
    return ops.matmul(ops.mul(g, u), p["w_down"])


def gated_mlp_block(p: dict, x, act: str = "silu"):
    """The block with its residual add: ``x + mlp(x)``."""
    return ops.add(apply_gated_mlp(p, x, act), x)


# ---------------------------------------------------------------------------
# eager tensor functions (the serving path)
# ---------------------------------------------------------------------------

def gated_mlp_spec(d: int, d_ff: int) -> dict:
    return {
        "w_gate": Spec((d, d_ff), ("embed", "ffn"), init="xavier"),
        "w_up": Spec((d, d_ff), ("embed", "ffn"), init="xavier"),
        "w_down": Spec((d_ff, d), ("ffn", "embed"), init="xavier"),
    }


def gated_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    g = activation(act)(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def mlp_spec(d: int, d_ff: int, bias: bool = True) -> dict:
    s = {
        "w_in": Spec((d, d_ff), ("embed", "ffn"), init="xavier"),
        "w_out": Spec((d_ff, d), ("ffn", "embed"), init="xavier"),
    }
    if bias:
        s["b_in"] = Spec((d_ff,), ("ffn",), init="zeros")
        s["b_out"] = Spec((d,), (None,), init="zeros")
    return s


def plain_mlp(p: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if "b_in" in p:
        h = h + p["b_in"].to(dt)
    y = activation(act)(h) @ p["w_out"].to(dt)
    if "b_out" in p:
        y = y + p["b_out"].to(dt)
    return y
