"""Plain reference for qwen2-1.5b: the logits of a sequence, and the
training step (causal LM loss with the z-loss, AdamW with global-norm
clipping and a warmup + cosine rate), in float32 with TF32 off, or
(``fp8``) with every product's operands rounded to fp8.

Written from the configuration file and the published architecture:
pre-norm RMSNorm, q / k / v with biases, RoPE over halves, causal GQA,
a SwiGLU MLP, a final RMSNorm, logits against the tied embedding.  Reads
the weights the benchmark drew, laid out as the port's tree (stacked
layers); imports nothing of the port.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import plain

Z_LOSS = 1e-4


def _layer(x, lp: dict, cfg: dict, pos, fp8: bool):
    S = x.shape[0]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["hidden_size"] // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    a = lp["attn"]
    h = plain.rmsnorm(x, lp["ln1"]["scale"], eps)
    q = (plain.mm(h, a["wq"], fp8) + a["bq"].float()).view(S, H, D)
    k = (plain.mm(h, a["wk"], fp8) + a["bk"].float()).view(S, Hkv, D)
    v = (plain.mm(h, a["wv"], fp8) + a["bv"].float()).view(S, Hkv, D)
    o = plain.attention(plain.rope(q, pos, theta), plain.rope(k, pos, theta),
                        v, fp8=fp8).reshape(S, H * D)
    x = x + plain.mm(o, a["wo"], fp8)
    h = plain.rmsnorm(x, lp["ln2"]["scale"], eps)
    return mlp_block_residual(x, h, lp["mlp"], cfg, fp8)


def mlp_block_residual(x, h, p, cfg, fp8):
    act = plain.ACTS[cfg["hidden_act"]]
    g = act(plain.mm(h, p["w_gate"], fp8)) * plain.mm(h, p["w_up"], fp8)
    return x + plain.mm(g, p["w_down"], fp8)


def _take(tree, i):
    return {k: _take(v, i) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[i]


def logits(params: dict, tokens, cfg: dict, fp8: bool = False):
    """(S, vocab rows) logits of one sequence of token ids, the layers
    recomputed in the backward."""
    table = params["embed"]["table"].float()
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = table[tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(_layer, x, _take(params["layers"], i), cfg, pos,
                       fp8, use_reentrant=False)
    x = plain.rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    return plain.mm(x, table.t(), fp8)


def loss(params: dict, tokens, labels, cfg: dict, fp8: bool = False):
    """Mean token loss (the negative log-likelihood plus 1e-4 of the
    squared log-normaliser) over a (B, S) batch, a sequence at a time."""
    B, S = tokens.shape
    total = 0.0
    for b in range(B):
        out = logits(params, tokens[b], cfg, fp8)
        lse = torch.logsumexp(out, -1)
        picked = out.gather(-1, labels[b].long()[:, None])[:, 0]
        total = total + ((lse - picked) + Z_LOSS * lse * lse).sum()
    return total / (B * S)


def lr_at(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) /
                   max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def train_steps(params0: dict, batches, cfg: dict, opt: dict,
                fp8: bool = False) -> dict:
    """AdamW from ``params0`` over ``batches`` (each (tokens, labels)):
    each step's loss, every leaf's clipped gradient norm at step 1, and
    every leaf's change after the last step."""
    plain.no_tf32()
    flat0 = dict(_leaves(params0))
    names = list(flat0)
    p = {n: t.detach().float().clone() for n, t in flat0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad1 = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    for step, (tokens, labels) in enumerate(batches, start=1):
        leaves = [p[n].requires_grad_() for n in names]
        tree = _unflatten(dict(zip(names, leaves)))
        lval = loss(tree, tokens, labels, cfg, fp8)
        grads = torch.autograd.grad(lval, leaves)
        losses.append(float(lval.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
            lr = lr_at(step, opt)
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    grad1[n] = float(g.norm())
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[n] / (1 - b1 ** step)
                vh = v[n] / (1 - b2 ** step)
                pf = p[n].detach()
                p[n] = pf - lr * (mh / (vh.sqrt() + opt["eps"])
                                  + opt["weight_decay"] * pf)
        del grads, leaves, tree
    change = {n: float((p[n] - flat0[n].float()).norm()) for n in names}
    return {"losses": losses, "grad1": grad1, "change": change}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out
