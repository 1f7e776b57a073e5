"""Model FLOPs of qwen2-1.5b's work, counted from shapes: each product
once, 2 FLOPs a multiply-add; elementwise work, norms and the softmax
are not counted.  Causal attention counts the keys a query sees."""


def _dims(cfg):
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    return (d, cfg["intermediate_size"], cfg["num_attention_heads"] * hd,
            cfg["num_key_value_heads"] * hd)


def matmul_params(cfg) -> float:
    """Parameters that enter a product per token: every layer's
    projections and MLP, and the tied head over the vocabulary."""
    d, f, q, kv = _dims(cfg)
    layer = d * q + 2 * d * kv + q * d + 3 * d * f
    return float(cfg["num_hidden_layers"] * layer
                 + cfg["vocab_size"] * d)


def train_flops(cfg, traffic) -> float:
    """One training step over the traffic's ``batch`` x ``seq`` tokens:
    6 N a token (forward and backward) and causal attention's useful
    half, 6 L B S^2 H D."""
    _, _, q, _ = _dims(cfg)
    batch, seq = traffic["batch"], traffic["seq"]
    attn = 6.0 * cfg["num_hidden_layers"] * batch * seq * seq * q
    return 6.0 * matmul_params(cfg) * batch * seq + attn


def token_flops(cfg, context: int, head: bool = True) -> float:
    """The forward of one token that attends to ``context`` positions
    (itself included): 2 N, and q . k and p . v over the context; the
    head only where a token is sampled (``head``)."""
    d, _, q, _ = _dims(cfg)
    n = matmul_params(cfg) - (0 if head else cfg["vocab_size"] * d)
    return 2.0 * n + 4.0 * cfg["num_hidden_layers"] * context * q
