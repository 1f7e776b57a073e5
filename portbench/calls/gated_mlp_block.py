"""The port's gated MLP block with its residual (``x + down(act(x @
gate) * (x @ up))``, ``repro_torch.models.mlp.gated_mlp_block``) at the
configuration's widths, over the traffic's ``rows``, in its ``dtype``.

``build`` draws the weights and the input on the device from the
generator (the weights first, in this order) and returns the function to
compile, its inputs and its weights; ``reference/gated_mlp_block.py``
recomputes it from the same weights and inputs.
"""
from __future__ import annotations


def build(ctx, gen):
    torch = ctx.torch
    from repro_torch.models.mlp import gated_mlp_block

    from portbench import weights
    cfg, tr = ctx.config, ctx.traffic
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    dt = getattr(torch, tr["dtype"])
    params = {"w_gate": weights.normal(gen, (d, f), d ** -0.5, dt,
                                       ctx.device),
              "w_up": weights.normal(gen, (d, f), d ** -0.5, dt, ctx.device),
              "w_down": weights.normal(gen, (f, d), f ** -0.5, dt,
                                       ctx.device)}
    x = weights.normal(gen, (tr["rows"], d), 1.0, dt, ctx.device)

    def block(xv):
        return gated_mlp_block(params, xv, act=cfg["hidden_act"])
    return block, (x,), params
