"""Training: the port's ``make_train_step`` at the configuration's
widths, bf16 compute over a float32 master, AdamW.

Set-up draws the master weights, builds the step and its optimizer
state, and drives that same state through its first three steps with the
window's own call and feed; those steps are the ones the reference
follows.  The window then runs the steps that begin before ``--seconds``
has passed.  Every step's batch is fresh token ids drawn on the card from
the seed and the step's index, so all rows differ.

Compared with the reference (each number beside its limit): the worst
relative gap of the three losses; the worst leaf's gap between the
gradient norms the optimizer got at step 1 (read from its first moment:
m = (1 - b1) g after one step); the worst leaf's gap between the norms of
the change of the weights after step 3.  A gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient at step 1 is under a thousandth
of the median leaf's move under Adam by round-off alone, and are left out
of the change.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

FOLLOWED = 3
QUIET = 1e-3


def batch(ctx, index: int):
    """(tokens, labels) of step ``index`` (from 1): (B, S) each."""
    from portbench import weights
    tr = ctx.traffic
    gen = weights.generator(ctx.seed * 1_000_003 + 7919 * index,
                            ctx.device)
    seq = weights.tokens(gen, (tr["batch"], tr["seq"] + 1),
                         ctx.config["vocab_size"], ctx.device)
    return seq[:, :-1], seq[:, 1:]


def _gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def _worst(gaps: dict, k: int = 3) -> list:
    return sorted(([n, g] for n, g in gaps.items()), key=lambda x: -x[1])[:k]


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core.options import CompileOptions, use_options
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_leaves_with_path
    from repro_torch.optim import OptimizerConfig, init_opt_state

    from portbench import portcfg, weights
    tr = ctx.traffic
    opt = tr["optimizer"]
    model = build_model(portcfg.model_config(ctx))
    hp = steps_mod.TrainHParams(
        optimizer=OptimizerConfig(**opt), remat_policy=tr["remat"],
        compute_dtype=tr["compute_dtype"], master_dtype="float32")
    tokens_per_step = tr["batch"] * tr["seq"]
    with use_options(CompileOptions(device=ctx.device)):
        state = {"params": weights.tree(model.spec, ctx.seed, torch.float32,
                                        ctx.device)}
        state["opt"] = init_opt_state(state["params"], hp.optimizer)
        train_step = steps_mod.make_train_step(model, hp)

        def step(i):
            with ctx.span("portbench.train_step"):
                tokens, labels = batch(ctx, i)
                return train_step(state, {"tokens": tokens,
                                          "labels": labels})

        losses, grad1 = [], {}
        for i in range(1, FOLLOWED + 1):
            state, metrics = step(i)
            losses.append(float(metrics["loss"]))
            if i == 1:
                grad1 = {"/".join(p): float(m.norm()) / (1 - opt["b1"])
                         for p, m in tree_leaves_with_path(state["opt"]["m"])}
        params0 = weights.tree(model.spec, ctx.seed, torch.float32,
                               ctx.device)
        change = {"/".join(p): float((w - w0).norm()) for (p, w), w0 in zip(
            tree_leaves_with_path(state["params"]),
            [w for _, w in tree_leaves_with_path(params0)])}
        del params0
        n = 0
        with ctx.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                state, metrics = step(FOLLOWED + 1 + n)
                n += 1
        last_loss = float(metrics["loss"])
    del state, metrics, train_step
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    params0 = weights.tree(model.spec, ctx.seed, torch.float32, ctx.device)
    batches = [batch(ctx, i) for i in range(1, FOLLOWED + 1)]
    ref = ctx.reference.train_steps(params0, batches, ctx.config, opt)
    med = statistics.median(ref["grad1"].values())
    moving = [k for k, g in ref["grad1"].items() if g >= QUIET * med]

    def gaps(got: dict, worst: dict) -> dict:
        g = _gaps(got["grad1"], ref["grad1"], ref["grad1"])
        c = _gaps(got["change"], ref["change"], moving)
        worst.update(grad=_worst(g), change=_worst(c))
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                                zip(got["losses"], ref["losses"])),
                "grad_gap": max(g.values()), "change_gap": max(c.values())}

    worst, low_worst = {}, {}
    read = gaps({"losses": losses, "grad1": grad1, "change": change}, worst)
    counters = {"losses": losses, "ref_losses": ref["losses"],
                "quiet_leaves": sorted(set(ref["grad1"]) - set(moving)),
                "worst_leaves": worst}
    if ctx.control:
        counters["control"] = gaps(ctx.reference.train_steps(
            params0, batches, ctx.config, opt, fp8=True), low_worst)
        counters["control_worst_leaves"] = low_worst
    lim = ctx.limits
    return {"e2e": {"train_tok_s": n * tokens_per_step / ctx.window_s},
            "attempted": n, "failed": 0 if math.isfinite(last_loss) else n,
            "layer": {"steps": n, "dtype": tr["compute_dtype"],
                      "flops": n * ctx.flops.train_flops(ctx.config, tr)},
            "counters": dict(counters, last_loss=last_loss),
            "checks": [(k, v, lim[k]) for k, v in read.items()]}
