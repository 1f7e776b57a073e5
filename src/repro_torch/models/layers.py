"""Common layers: norms, embeddings, activations — the port of the
reference's ``models/layers.py`` (the parts the dense family uses).

Every layer is a (spec(), apply()) pair over plain dict trees of tensors;
the RMSNorm goes through ``kernels.ops.rmsnorm`` so the library-vs-kernel
decision of the ambient ``CompileOptions`` applies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain_params
from repro_torch.kernels import ops as kops
from repro_torch.models.spec import Spec


def cdt(cfg) -> torch.dtype:
    """The compute dtype of a config."""
    return getattr(torch, cfg.compute_dtype)


# -- norms -------------------------------------------------------------------

def norm_spec(d: int) -> dict:
    return {"scale": Spec((d,), (None,), init="ones")}


def layernorm_spec(d: int) -> dict:
    return {"scale": Spec((d,), (None,), init="ones"),
            "bias": Spec((d,), (None,), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    if kind == "rmsnorm":
        return kops.rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# -- embedding -----------------------------------------------------------------

def apply_embed(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The table's rows at ``tokens`` (``jnp.take`` on axis 0).  Under a
    mesh the table is first gathered along the vocab (its d_model dim
    stays sharded): the rows are then a plain lookup, where DTensor's
    vocab-sharded lookup and an indexing's backward have no strategy
    that works across torch releases; the identity without a mesh."""
    table = constrain_params(p["table"], (None, "embed"))
    return F.embedding(tokens.long(), table).to(cdt(cfg))


def apply_unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ tableᵀ."""
    return x @ p["table"].T.to(x.dtype)


def activation(kind: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[kind]
