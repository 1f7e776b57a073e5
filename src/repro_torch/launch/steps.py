"""The train step — the training half of the reference's
``launch/steps.py``.

``make_train_step`` implements the reference's recipe on one device:

* f32 master weights with the optimizer moments beside them;
* compute params cast from the master inside the step (bf16 by
  default).  The step differentiates the *compute* tree, as the
  reference does, so the gradients come out in the compute dtype; the
  compute leaves are fresh autograd leaves (cast, detached), so the
  master never enters the autograd graph — an f32 compute dtype casts an
  f32 master to itself, and the detach keeps that leaf apart too;
* microbatch gradient accumulation in ``accum_dtype``;
* per-layer remat with the reference's policies
  (``models/transformer.py``).

The reference's sharding trees (``train_state_shardings``,
``batch_shardings``, ``cache_shardings``) wait for the port's
distribution slice; its donation of the state has no counterpart: the
step returns a new state and the caller drops the old one.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import OptimizerConfig, init_opt_state, opt_update


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    optimizer: OptimizerConfig = OptimizerConfig()
    remat_policy: str = "nothing"      # none | nothing | dots | dots_no_batch
    microbatches: int = 1
    accum_dtype: str = "float32"       # float32 | bfloat16
    aux_weight: float = 0.01
    compute_dtype: str = "bfloat16"
    master_dtype: str = "float32"      # bfloat16 for the ≥100B archs
    scan_unroll: int = 1


def cast_compute(tree, dtype):
    """Every floating leaf of a tree of dicts cast to ``dtype`` (a leaf
    already in it is returned as it is)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                    tree)


def init_train_state(model, hp: TrainHParams, seed: int = 0,
                     device: str = "cuda") -> dict:
    params = cast_compute(model.init(seed, device), hp.master_dtype)
    return {"params": params, "opt": init_opt_state(params, hp.optimizer)}


def _split(x: torch.Tensor, key: str, k: int) -> torch.Tensor:
    """A batch entry as k microbatches along a new leading dim."""
    if key == "vision_positions":           # (3, B, …): batch is dim 1
        return x.reshape((3, k, x.shape[1] // k) + x.shape[2:]) \
            .transpose(0, 1)
    return x.reshape((k, x.shape[0] // k) + x.shape[1:])


def make_train_step(model, hp: TrainHParams):
    """→ ``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the state's device."""

    def loss_and_grads(master, batch):
        compute = tree_map(lambda p: p.detach().requires_grad_(),
                           cast_compute(master, hp.compute_dtype))
        leaves = tree_leaves(compute)
        loss = model.loss(compute, batch, remat_policy=hp.remat_policy,
                          aux_weight=hp.aux_weight,
                          scan_unroll=hp.scan_unroll)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
        return loss.detach(), tree_map(lambda _: next(it), compute)

    def train_step(state, batch):
        master = state["params"]
        if hp.microbatches <= 1:
            loss, grads = loss_and_grads(master, batch)
        else:
            k = hp.microbatches
            mbs = {key: _split(v, key, k) for key, v in batch.items()}
            acc_dt = getattr(torch, hp.accum_dtype)
            grads, loss = None, 0.0
            for i in range(k):
                l, g = loss_and_grads(master,
                                      {key: v[i] for key, v in mbs.items()})
                g = tree_map(lambda gg: gg.to(acc_dt), g)
                grads = g if grads is None else \
                    tree_map(torch.Tensor.add_, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
        new_params, new_opt, metrics = opt_update(
            master, grads, state["opt"], hp.optimizer)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss.to(torch.float32), **metrics})

    return train_step
