"""Step functions and their sharding trees — the port of the
reference's ``launch/steps.py``: the units the dry-run counts and the
train / serve loops execute.

``make_train_step`` implements the reference's recipe:

* f32 master weights with the optimizer moments beside them (FSDP + TP
  sharded under a mesh, the moments sharded as their parameters);
* compute params cast from the master inside the step (bf16 by
  default).  The step differentiates the *compute* tree, as the
  reference does, so the gradients come out in the compute dtype; the
  compute leaves are fresh autograd leaves (cast, detached), so the
  master never enters the autograd graph — an f32 compute dtype casts an
  f32 master to itself, and the detach keeps that leaf apart too;
* the gradients and the microbatch accumulator constrained to the
  parameter shardings (``dist.sharding.constrain_params``, the identity
  without a mesh), at the reference's three places;
* microbatch gradient accumulation in ``accum_dtype``;
* per-layer remat with the reference's policies
  (``models/transformer.py``).

Under a ``DeviceMesh`` the state and batch are DTensors placed by
:func:`train_state_shardings` / :func:`batch_shardings`
(``dist.sharding.distribute_tree``), and the step runs on them
unchanged.  The reference's donation of the state has no counterpart:
the step returns a new state and the caller drops the old one.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import sharding as shd
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


def abstract_train_state(model, hp: TrainHParams) -> dict:
    """The train state as meta tensors: the master tree in
    ``master_dtype`` and the optimizer state built on it."""
    params = cast_compute(model.abstract(), hp.master_dtype)
    return {"params": params, "opt": init_opt_state(params, hp.optimizer)}


def _split(x: torch.Tensor, key: str, k: int) -> torch.Tensor:
    """A batch entry as k microbatches along a new leading dim."""
    if key == "vision_positions":           # (3, B, …): batch is dim 1
        return shd.reshape(x, (3, k, x.shape[1] // k) + x.shape[2:]) \
            .transpose(0, 1)
    return shd.reshape(x, (k, x.shape[0] // k) + x.shape[1:])


def _batch_sharded(mb: dict) -> dict:
    """A microbatch constrained to the batch sharding (dim 0 over the
    data axes; ``vision_positions`` whole, as ``batch_shardings`` places
    them): where the data axes do not divide the microbatch count, the
    split replicated the rows, and each device takes its own back."""
    return {k: v if k == "vision_positions" or v.dim() == 0 else
            shd.constrain(v, "batch", *([None] * (v.dim() - 1)))
            for k, v in mb.items()}


def make_train_step(model, hp: TrainHParams):
    """→ ``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the state's device (DTensors on its mesh)."""
    axes = model.axes()

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
            grads = shd.constrain_params(grads, axes)
        else:
            k = hp.microbatches
            mbs = {key: _split(v, key, k) for key, v in batch.items()}
            acc_dt = getattr(torch, hp.accum_dtype)
            grads, loss = None, 0.0
            for i in range(k):
                l, g = loss_and_grads(master, _batch_sharded(
                    {key: v[i] for key, v in mbs.items()}))
                # pin per-microbatch grads (and the running accumulator)
                # to the param shardings, as the reference does
                g = shd.constrain_params(g, axes)
                g = tree_map(lambda gg: gg.to(acc_dt), g)
                grads = g if grads is None else \
                    tree_map(torch.Tensor.add_, grads, g)
                grads = shd.constrain_params(grads, axes)
                loss = loss + l
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
        new_params, new_opt, metrics = opt_update(
            master, grads, state["opt"], hp.optimizer)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss.to(torch.float32), **metrics})

    return train_step


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def train_state_shardings(mesh, model, hp: TrainHParams) -> dict:
    """The state's NamedSharding tree: params by the param rules, the
    moments (``m``, ``v``, ``ef``) as their params, Adafactor's factors
    and the step replicated."""
    pshard = shd.param_shardings(mesh, model.abstract(), model.axes())
    rep = shd.NamedSharding(mesh, shd.P())
    opt = {}
    for key, val in abstract_train_state(model, hp)["opt"].items():
        if key in ("m", "v", "ef"):
            opt[key] = pshard
        elif key == "fac":
            opt[key] = tree_map(lambda a: rep, val)
        else:
            opt[key] = rep
    return {"params": pshard, "opt": opt}


def batch_shardings(mesh, specs: dict) -> dict:
    return {k: shd.batch_sharding(mesh, tuple(v.shape))
            if len(v.shape) and k != "vision_positions"
            else shd.NamedSharding(mesh, shd.P(*([None] * len(v.shape))))
            for k, v in specs.items()}


def cache_shardings(mesh, cache_abs) -> dict:
    """Generic cache rule: dim1 = batch over FSDP axes; dim2 sharded over
    "model" when it divides (kv heads); everything else replicated."""
    fsdp = shd._mesh_axes(mesh, shd.FSDP_AXES)
    model_ax = "model" if "model" in shd.axis_names(mesh) else None
    fsdp_n = shd._axis_size(mesh, fsdp) if fsdp else 1
    model_n = shd._axis_size(mesh, model_ax) if model_ax else 1

    def rule(a):
        parts = [None] * len(a.shape)
        if len(a.shape) >= 2 and a.shape[1] % fsdp_n == 0 and fsdp:
            parts[1] = fsdp if len(fsdp) > 1 else fsdp[0]
        if len(a.shape) >= 4 and model_ax and a.shape[2] % model_n == 0 \
                and a.shape[2] >= model_n:
            parts[2] = model_ax            # kv heads over "model"
        elif len(a.shape) >= 5 and model_ax and \
                a.shape[3] % model_n == 0 and a.shape[3] >= model_n:
            # MHA caches (40 heads ∤ 16): shard the *sequence* dim instead
            parts[3] = model_ax
        return shd.NamedSharding(mesh, shd.P(*parts))

    return tree_map(rule, cache_abs)


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_decode_step(model):
    def decode_step(params, token, cache, length):
        return model.decode_step(params, token, cache, length)
    return decode_step


def make_prefill_step(model, *, max_len: int, quantized: bool = False):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len,
                             quantized=quantized)
    return prefill_step
