"""A compiled call: ``pipeline.compile`` of the function that the
traffic's ``call`` names (``calls/<call>.py``), for the traffic's
``target``, called back to back on the same inputs for the window.

``call_ms`` is the window's time over the calls made in it; the window
ends in a synchronize.  The outputs of calls drawn from the seed (the
first, two more, and the last) are kept and compared row by row with the
call's plain reference (``reference/<call>.py``) in float32.
"""
from __future__ import annotations

import random
import time


def build(ctx):
    """(compiled module, inputs, weights) at the cell's sizes."""
    from repro_torch.core import pipeline
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.tracer import TensorSpec

    from portbench import harness, weights
    tr = ctx.traffic
    call = harness.load_module(harness.PB / "calls" / f"{tr['call']}.py")
    fn, args, params = call.build(ctx, weights.generator(ctx.seed,
                                                         ctx.device))
    mod = pipeline.compile(fn, *(TensorSpec.of(a) for a in args),
                           options=CompileOptions(target=tr["target"],
                                                  device=ctx.device))
    return mod, args, params


def row_error(y, ref) -> float:
    """The largest over rows of |y - ref| / |ref| (2-norms of a row)."""
    y = y.float().reshape(-1, y.shape[-1])
    ref = ref.reshape(-1, ref.shape[-1])
    return float(((y - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def run(ctx) -> dict:
    mod, args, params = build(ctx)
    tr = ctx.traffic
    for _ in range(tr["warmup_calls"]):
        mod(*args)
    rng = random.Random(ctx.seed)
    keep = {0, rng.randrange(1, 200), rng.randrange(200, 2000)}
    kept, n = [], 0
    with ctx.window():
        t0 = time.perf_counter()
        while True:
            with ctx.span("portbench.call"):
                y = mod(*args)
            if n in keep:
                kept.append(y)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    kept.append(y)
    launches = mod.launch_count
    del mod
    cfg = ctx.config
    ref = ctx.reference.call(args, params, cfg, tr)
    err = max(row_error(y, ref) for y in kept)
    counters = {"launch_count": launches, "outputs_compared": len(kept)}
    if ctx.control:
        low = ctx.reference.call(args, params, cfg, tr, fp8=True)
        counters["control"] = {"row_err": row_error(low, ref)}
    pf, pb = ctx.flops.call_products(cfg, tr)
    return {"e2e": {"call_ms": ctx.window_s * 1e3 / n},
            "attempted": n, "failed": 0,
            "layer": {"calls": n, "dtype": tr["dtype"],
                      "flops": n * ctx.flops.call_flops(cfg, tr),
                      "product_flops": n * pf, "product_bytes": n * pb},
            "counters": counters,
            "checks": [("row_err", err, ctx.limits["row_err"])]}
