"""Work of grok-1-314b's decode step, counted from shapes (2 FLOPs a
multiply-add, bf16 operands): what the tokens need, not the padded
slots the port computes, so that less padding reads as a larger share
of the same bound."""


def _contexts(traffic) -> list:
    """Each slot's cached positions before the step."""
    lo, spread = traffic["context_min"], traffic["context_spread"]
    return [lo + i % spread for i in range(traffic["slots"])]


def ffn_size(cfg) -> int:
    """``model.py``'s ``ffn_size``: two thirds of widening_factor ·
    emb_size, rounded up to a multiple of 8."""
    f = int(cfg["widening_factor"] * cfg["emb_size"]) * 2 // 3
    return f + (8 - f) % 8


def expert_products(cfg, traffic) -> tuple:
    """(FLOPs, bytes) of one step's expert products over every layer:
    each slot's token through its experts' three matrices, and every
    held expert's three bf16 matrices read once."""
    M, F, E = cfg["emb_size"], ffn_size(cfg), cfg["num_experts"]
    L, k = cfg["num_layers"], cfg["num_selected_experts"]
    flops = 2.0 * 3 * M * F * k * traffic["slots"] * L
    return flops, 2.0 * 3 * M * F * E * L


def decode_attention_bytes(cfg, traffic) -> float:
    """One step's decode-attention kernel bytes over every layer, bf16:
    each slot's K and V at its valid positions (the new one included)
    read once, its query heads read and its output written."""
    kv = cfg["num_kv_heads"] * cfg["key_size"]
    q = cfg["num_q_heads"] * cfg["key_size"]
    per_layer = sum(2 * 2 * (n + 1) * kv + 2 * 2 * q
                    for n in _contexts(traffic))
    return float(cfg["num_layers"] * per_layer)
