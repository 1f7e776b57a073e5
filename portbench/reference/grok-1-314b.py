"""Plain reference for grok-1-314b: the logits of token sequences, in
float32 with TF32 off, or (``fp8``) with every product's operands
rounded to fp8.

Written from xAI's release (github.com/xai-org/grok-1, ``run.py``'s
``LanguageModelConfig`` / ``TransformerConfig`` and ``model.py``) and the
configuration file: the input embedding times
``embedding_multiplier_scale``; in each layer RMSNorm (ε
``rms_norm_eps``) before attention and after it, the post-norm's output
added to the residual, and the same around the MoE; attention with
RoPE over halves (base ``rope_base``), GQA, the scores times
``attn_output_multiplier`` and capped at ``attn_logit_cap`` · tanh(s /
cap), causal; the MoE router's softmax over all experts in float32, the
top ``num_selected_experts`` of those probabilities as the gates, not
renormalised, every token computed by its experts (no capacity, no
drop), each expert a GeGLU (tanh gelu of x · w_gate, times x · w_up,
then w_down); the final RMSNorm, logits against the embedding table
(one ``InOutEmbed``: a tied head) times ``output_multiplier_scale``.

Departures: the weights are the benchmark's seeded draws, laid out as
the port's tree (stacked layers; the norms' scales multiply, as
``model.py``'s ``RMSNorm`` does); the router's product is in float32 on
the normed input, as published.  Reads only ``torch`` and
``reference/plain.py``: nothing of the port.

The work is done in blocks so that it fits on one card beside the
program: one layer at a time, and inside it one expert's three matrices
upcast to float32 at a time, for every sequence together.  Where a
sequence's last token has other experts' router probabilities within
``tie_delta`` of its k-th at some layer, each choice of its k experts
from that band is followed from there on (each is grok-1 up to
rounding, ``choices``): ``last_logits`` returns every such
alternative's row.
"""
from __future__ import annotations

import torch

from portbench.reference import plain


def _dims(cfg: dict) -> dict:
    return {"H": cfg["num_q_heads"], "Hkv": cfg["num_kv_heads"],
            "D": cfg["key_size"], "k": cfg["num_selected_experts"],
            "eps": cfg["rms_norm_eps"]}


def _w(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _attention(q, k, v, cfg: dict, fp8: bool):
    """Causal GQA over one sequence (q (S, H, D), k / v (S, Hkv, D)),
    the scores scaled, then capped."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = plain.mm(q.transpose(0, 1), k.permute(1, 2, 0), fp8) \
        * cfg["attn_output_multiplier"]
    cap = cfg["attn_logit_cap"]
    s = cap * torch.tanh(s / cap)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return plain.mm(p, v.transpose(0, 1), fp8).transpose(0, 1)


def _attention_last(q, k, v, k_own, v_own, cfg: dict, fp8: bool):
    """The last token's alternatives (q (A, H, D), each with its own key
    and value (A, Hkv, D)) against the shared context (k / v (S - 1,
    Hkv, D)) and their own key: no mask."""
    A, H, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    qg = q.view(A, Hkv, rep, D)
    s_ctx = plain.mm(qg.permute(1, 0, 2, 3).reshape(Hkv, A * rep, D),
                     k.permute(1, 2, 0), fp8)              # (Hkv,A*rep,S-1)
    s_ctx = s_ctx.view(Hkv, A, rep, -1).permute(1, 0, 2, 3)
    s_own = plain.mm(qg.reshape(A * Hkv, rep, D),
                     k_own.reshape(A * Hkv, D, 1), fp8)    # (A*Hkv,rep,1)
    s = torch.cat([s_ctx, s_own.view(A, Hkv, rep, 1)], -1) \
        * cfg["attn_output_multiplier"]                    # (A,Hkv,rep,S)
    cap = cfg["attn_logit_cap"]
    p = torch.softmax(cap * torch.tanh(s / cap), -1)
    n = k.shape[0]
    o = plain.mm(p[..., :n].permute(1, 0, 2, 3).reshape(Hkv, A * rep, n),
                 v.transpose(0, 1), fp8).view(Hkv, A, rep, D) \
        .permute(1, 0, 2, 3)
    o = o + plain.mm(p[..., n:].reshape(A * Hkv, rep, 1),
                     v_own.reshape(A * Hkv, 1, D), fp8).view(A, Hkv, rep, D)
    return o.reshape(A, H, D)


def _subsets(items: list, n: int) -> list:
    """Every choice of ``n`` of ``items``, in their order."""
    if n == 0:
        return [[]]
    return [[items[i]] + rest for i in range(len(items))
            for rest in _subsets(items[i + 1:], n - 1)]


def choices(probs: torch.Tensor, order: torch.Tensor, k: int,
            tie_delta: float) -> list:
    """The expert sets one row may take: its top k and, where experts'
    probabilities lie within ``tie_delta`` of its k-th, every set of k
    that keeps the experts above that band and fills up from it."""
    pk = float(probs[order[k - 1]])
    if tie_delta <= 0:
        return [order[:k]]
    p = [float(probs[e]) for e in order]
    sure = [int(e) for e, v in zip(order, p) if v > pk + tie_delta]
    band = [int(e) for e, v in zip(order, p) if abs(v - pk) <= tie_delta]
    return [torch.tensor(sure + c, device=order.device)
            for c in _subsets(band, k - len(sure))]


def route(h: torch.Tensor, router: torch.Tensor, fp8: bool = False):
    """The router's probabilities (rows, E) in float32 and the experts
    in their order, largest first (a tie to the lower index): the first
    k are a row's experts, their probabilities its gates."""
    probs = torch.softmax(plain.mm(h, router, fp8), -1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    return probs, idx


def experts(h: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
            moe: dict, layer: int, fp8: bool = False) -> torch.Tensor:
    """Every row through its experts (``idx`` (rows, k)), weighted by
    ``gates`` (rows, k): one expert upcast at a time."""
    out = torch.zeros_like(h)
    for e in range(moe["w_gate"].shape[1]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = plain.gelu_tanh(plain.mm(x, _w(moe["w_gate"][layer, e]), fp8))
        u = plain.mm(x, _w(moe["w_up"][layer, e]), fp8)
        y = plain.mm(g * u, _w(moe["w_down"][layer, e]), fp8)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out


def _norm(x, scale, eps):
    return plain.rmsnorm(x, scale, eps)


def _hidden(params: dict, seqs: list, cfg: dict, fp8: bool,
            tie_delta: float) -> tuple:
    """For each token sequence of ``seqs`` (1-d ids, lengths may differ)
    the last layer's output: its context rows (S - 1, M), its last
    token's rows (A, M), one for each routing alternative (A = 1 without
    a tie within ``tie_delta``), and the ties followed."""
    plain.no_tf32()
    d = _dims(cfg)
    H, Hkv, D, k, eps = d["H"], d["Hkv"], d["D"], d["k"], d["eps"]
    theta = cfg["rope_base"]
    table = params["embed"]["table"]
    L = params["layers"]["attn"]["wq"].shape[0]
    lay = params["layers"]
    # per sequence: context x (S-1, M), its k / v per layer, and the
    # last token's alternatives X (A, M)
    ctx = [_w(table[s[:-1].long()]) * cfg["embedding_multiplier_scale"]
           for s in seqs]
    alt = [_w(table[s[-1:].long()]) * cfg["embedding_multiplier_scale"]
           for s in seqs]
    ties = [0] * len(seqs)
    with torch.no_grad():
        for i in range(L):
            a = {n: _w(lay["attn"][n][i]) for n in ("wq", "wk", "wv", "wo")}
            sc = {n: lay[n]["scale"][i] for n in
                  ("ln1", "ln1_post", "ln2", "ln2_post")}
            for j, s in enumerate(seqs):
                S = s.shape[0]
                pos = torch.arange(S, device=s.device)
                x, X = ctx[j], alt[j]
                h = _norm(torch.cat([x, X]), sc["ln1"], eps)
                n_ctx, A = x.shape[0], X.shape[0]
                q = plain.mm(h, a["wq"], fp8).view(-1, H, D)
                kk = plain.mm(h, a["wk"], fp8).view(-1, Hkv, D)
                vv = plain.mm(h, a["wv"], fp8).view(-1, Hkv, D)
                p_all = torch.cat([pos[:-1], pos[-1:].expand(A)])
                q = plain.rope(q, p_all, theta)
                kk = plain.rope(kk, p_all, theta)
                o_ctx = _attention(q[:n_ctx], kk[:n_ctx], vv[:n_ctx], cfg,
                                   fp8)
                o_alt = _attention_last(q[n_ctx:], kk[:n_ctx], vv[:n_ctx],
                                        kk[n_ctx:], vv[n_ctx:], cfg, fp8)
                o = torch.cat([o_ctx, o_alt]).reshape(-1, H * D)
                y = _norm(plain.mm(o, a["wo"], fp8), sc["ln1_post"], eps)
                xs = torch.cat([x, X]) + y
                ctx[j], alt[j] = xs[:n_ctx], xs[n_ctx:]
            del a
            # the MoE: route every row, split a last token's alternative
            # where experts' probabilities nearly tie with its k-th
            router = _w(lay["moe"]["router"][i])
            hs, idxs, gates = [], [], []
            for j in range(len(seqs)):
                x, X = ctx[j], alt[j]
                h = _norm(torch.cat([x, X]), sc["ln2"], eps)
                probs, order = route(h, router, fp8)
                n_ctx = x.shape[0]
                rows_i, rows_p = [order[:n_ctx, :k]], [probs]
                rows_h, extra_x = [h[:n_ctx]], []
                for r in range(n_ctx, h.shape[0]):
                    sets = choices(probs[r], order[r], k, tie_delta)
                    ties[j] += len(sets) > 1
                    for c in sets:
                        rows_i.append(c[None])
                        rows_h.append(h[r:r + 1])
                        rows_p.append(probs[r:r + 1])
                        extra_x.append(X[r - n_ctx:r - n_ctx + 1])
                idx = torch.cat(rows_i)
                hh = torch.cat(rows_h)
                pp = torch.cat([rows_p[0][:n_ctx]] + rows_p[1:])
                alt[j] = torch.cat(extra_x)
                hs.append(hh)
                idxs.append(idx)
                gates.append(torch.gather(pp, 1, idx))
            sizes = [h.shape[0] for h in hs]
            y = experts(torch.cat(hs), torch.cat(idxs), torch.cat(gates),
                        lay["moe"], i, fp8)
            y = _norm(y, sc["ln2_post"], eps)
            for j, part in enumerate(torch.split(y, sizes)):
                n_ctx = ctx[j].shape[0]
                ctx[j] = ctx[j] + part[:n_ctx]
                alt[j] = alt[j] + part[n_ctx:]
    return ctx, alt, ties


def _head(params: dict, x: torch.Tensor, cfg: dict, fp8: bool):
    """The final norm, the tied head and the output multiplier."""
    h = _norm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    with torch.no_grad():
        return plain.mm(h, _w(params["embed"]["table"]).t(), fp8) \
            * cfg["output_multiplier_scale"]


def last_logits(params: dict, seqs: list, cfg: dict, fp8: bool = False,
                tie_delta: float = 0.0) -> list:
    """For each token sequence of ``seqs`` (1-d ids, lengths may differ):
    the logits (A, vocab) of its last position, one row for each routing
    alternative of that token, and the number of ties followed."""
    _, alt, ties = _hidden(params, seqs, cfg, fp8, tie_delta)
    return [(_head(params, x, cfg, fp8), t) for x, t in zip(alt, ties)]


def logits(params: dict, tokens: torch.Tensor, cfg: dict,
           fp8: bool = False) -> torch.Tensor:
    """(S, vocab) logits of one sequence at every position."""
    ctx, alt, _ = _hidden(params, [tokens], cfg, fp8, 0.0)
    return _head(params, torch.cat([ctx[0], alt[0]]), cfg, fp8)
