"""Operations and bytes of one call of the gated MLP block over the
traffic's ``rows``, counted from shapes: x @ gate, x @ up and h @ down,
2 FLOPs a multiply-add; the activation, the product and the residual are
not counted.  Bytes count each product's operands read once and its
output written once, in the traffic's dtype."""

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def call_flops(cfg, traffic) -> float:
    d, f, rows = cfg["hidden_size"], cfg["intermediate_size"], \
        traffic["rows"]
    return 3 * 2.0 * rows * d * f


def call_products(cfg, traffic) -> tuple:
    """(FLOPs, bytes) of the call's matrix products."""
    d, f, rows = cfg["hidden_size"], cfg["intermediate_size"], \
        traffic["rows"]
    up = rows * d + d * f + rows * f            # x, W, out: gate and up
    down = rows * f + f * d + rows * d
    return call_flops(cfg, traffic), \
        float(ITEMSIZE[traffic["dtype"]] * (2 * up + down))
