"""Optimizers — the port of the reference's ``optim/optimizer.py``: AdamW
(f32 master + moments) and Adafactor (factored second moment, the
memory-lean option), with global-norm clipping and a warmup + cosine
schedule.

Plain functions on trees (nested dicts) of tensors, functional as the
reference's: :func:`opt_update` returns new parameter and state trees and
leaves its inputs as they were.  ``torch.optim`` is not used: the
schedule (warmup, cosine, a floor at ``min_lr_ratio``) is computed from
the state's step inside the update, the gradient transforms and the
clip see the whole tree first, and each leaf's update is the
reference's formula in its order of f32 operations.  The master weights
live here; the train step casts master → compute dtype, differentiates
the compute tree, and hands its (bf16) gradients back.  An optional
int8 + error-feedback gradient transform is a further knob.

Which path runs is read from the leaves, with no switch:

* AdamW over plain tensors (``type(t) is torch.Tensor``, every leaf on
  the CPU or every leaf on the card): ``kernels/adamw.py::adamw``.  On
  the card that is the fused kernels of ``csrc/adamw.cu`` (the gradients
  read in their own dtype, 2 × leaves + 1 launches, no host sync, the
  plain branch's bits without clipping); on the CPU its plain version.
* AdamW over DTensors (a mesh: the norm would need a reduction across
  shards) or meta tensors (the dry-run): the plain branch,
  ``kernels/adamw.py::plain``, through torch's own dispatch.
* Adafactor: its plain branch here, on every device.

A gradient transform (``bf16``, ``int8_ef``) runs first in plain torch on
f32 copies, and AdamW reads its f32 output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.kernels import adamw as fused_adamw
from repro_torch.models.spec import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient transform: none | bf16 | int8_ef (error feedback)
    grad_transform: str = "none"


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples → n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def lr_at(step, hp: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - hp.warmup_steps) /
                       max(hp.total_steps - hp.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.lr * warm * (hp.min_lr_ratio + (1 - hp.min_lr_ratio) * cos)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_opt_state(params, hp: OptimizerConfig) -> dict:
    """params = the master tree; the state's leaves sit on its device."""
    if hp.kind == "adamw":
        state = {"m": tree_map(torch.zeros_like, params),
                 "v": tree_map(torch.zeros_like, params)}
    elif hp.kind == "adafactor":
        def fac(p):
            # factored moments are tiny → keep them f32 even when the
            # master weights are bf16
            f32 = {"dtype": torch.float32, "device": p.device}
            if p.ndim < 2:
                return {"v": torch.zeros(p.shape, **f32)}
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        state = {"fac": tree_map(fac, params)}
    else:
        raise ValueError(hp.kind)
    if hp.grad_transform == "int8_ef":
        state["ef"] = tree_map(torch.zeros_like, params)
    state["step"] = torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)
    return state


# ---------------------------------------------------------------------------
# gradient transforms (compression)
# ---------------------------------------------------------------------------

def _quantize_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
    q = torch.round(g / scale).to(torch.int8)
    return q.to(torch.float32) * scale


def transform_grads(grads, state: dict, hp: OptimizerConfig) -> Tuple:
    if hp.grad_transform == "none":
        return grads, state
    if hp.grad_transform == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32),
                        grads), state

    if hp.grad_transform == "int8_ef":
        def one(g, e):
            corrected = g.to(torch.float32) + e
            q = _quantize_int8(corrected)
            return q, corrected - q
        new_g, new_ef = _unzip(tree_map(one, grads, state["ef"]), 2)
        return new_g, dict(state, ef=new_ef)
    raise ValueError(hp.grad_transform)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """The f32 norm over every leaf of a tree (or of a list of leaves)."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves))


def clip_scale(gnorm, hp: OptimizerConfig):
    """The global-norm clip's factor on every gradient (1.0 unclipped)."""
    return torch.clamp(hp.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0) if hp.clip_norm else 1.0


def _fusable(leaves) -> bool:
    """Every leaf a plain tensor (no DTensor or other subclass) on the CPU
    or the card: :func:`kernels.adamw.adamw` takes them (and raises on a
    mix of the two)."""
    return all(type(t) is torch.Tensor and t.device.type in ("cpu", "cuda")
               for t in leaves)


@torch.no_grad()
def opt_update(params, grads, state: dict, hp: OptimizerConfig
               ) -> Tuple[Any, dict, dict]:
    """→ (new_params, new_state, metrics).  params / grads trees align;
    grads may be bf16.  The clip scale multiplies each
    gradient inside its leaf's update, so no second scaled tree is
    held (the reference scales the tree first; the values are the
    same).  The module docstring says which path runs."""
    if hp.kind == "adamw":
        if hp.grad_transform != "none":
            grads, state = transform_grads(
                tree_map(lambda g: g.to(torch.float32), grads), state, hp)
        quads = []
        tree_map(lambda *t: quads.append(t), params, grads, state["m"],
                 state["v"])
        ps, gs, ms, vs = (list(x) for x in zip(*quads))
        update = fused_adamw.adamw if _fusable(ps + gs + ms + vs) \
            else fused_adamw.plain
        new_p, new_m, new_v, step, gnorm, lr = update(
            ps, gs, ms, vs, state["step"], hp)

        def like(leaves):
            it = iter(leaves)
            return tree_map(lambda _: next(it), params)
        return like(new_p), dict(state, m=like(new_m), v=like(new_v),
                                 step=step), {"grad_norm": gnorm, "lr": lr}

    grads = tree_map(lambda g: g.to(torch.float32), grads)
    grads, state = transform_grads(grads, state, hp)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, hp)
    step = state["step"] + 1
    lr = lr_at(step, hp)
    metrics = {"grad_norm": gnorm, "lr": lr}

    if hp.kind == "adafactor":
        eps = 1e-30
        decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8

        def upd(p, g, f):
            g = g * scale
            g2 = torch.square(g) + eps
            if p.ndim < 2:
                v = decay * f["v"] + (1 - decay) * g2
                u = g * torch.rsqrt(v + eps)
                nf = {"v": v}
            else:
                vr = decay * f["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * f["vc"] + (1 - decay) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                v_est = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                u = g * torch.rsqrt(v_est + eps)
                nf = {"vr": vr, "vc": vc}
            # update clipping (Adafactor RMS rule)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms, min=1.0)
            pf = p.to(torch.float32)
            new_p = (pf - lr * (u + hp.weight_decay * pf)).to(p.dtype)
            return new_p, nf

        new_params, fac = _unzip(tree_map(upd, params, grads, state["fac"]),
                                 2)
        return new_params, dict(state, fac=fac, step=step), metrics

    raise ValueError(hp.kind)
