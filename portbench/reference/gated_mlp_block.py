"""Plain reference of the gated MLP block with its residual:
x + down(act(x @ gate) * (x @ up)), in float32 with TF32 off, or
(``fp8``) with every product's operands rounded to fp8.  Imports nothing
of the port."""
from __future__ import annotations

from portbench.reference import plain


def call(args, p: dict, cfg: dict, traffic: dict, fp8: bool = False):
    plain.no_tf32()
    act = plain.ACTS[cfg["hidden_act"]]
    x = args[0].float()
    h = act(plain.mm(x, p["w_gate"], fp8)) * plain.mm(x, p["w_up"], fp8)
    return x + plain.mm(h, p["w_down"], fp8)
