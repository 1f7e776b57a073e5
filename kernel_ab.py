#!/usr/bin/env python3
"""Time kernels of one checkout at shapes that ``chip_smoke.py`` of an
older checkout may not time, so that two commits can be set side by side
on one card:

    python3 kernel_ab.py [ROOT]      # ROOT: a checkout (default: this one)

Run it on both checkouts in one call, in turns (A, B, B, A).  It imports
``ROOT/src/repro_torch`` only, and prints the card (``nvidia-smi``) and one
JSON line: device ms (CUDA events, the 50 MB L2 flushed and the card held
busy before each call, median of 15) of

* flash attention in f32 at recurrentgemma-9b's 4 x 16 / 1 heads x 2040 x
  256, window 2048, beside SDPA in f32 (``is_causal``; S <= window);
* the WKV scan at rwkv6-3b's prefill, 4 x 512 x 40 x 64, in f32 and bf16
  (decays in [0.97, 0.999)), and the wrapper's host microseconds a call
  (40 calls enqueued back to back, median of 5);
* the qwen2-1.5b MLP block's two mapped nests at T = 2048 (silu.mul
  2048 x 8960, the residual add 2048 x 1536) in f32 and bf16 through
  ``block_map_region`` at the tiling the pass gives them, beside
  ``torch.add``;
* SpMM of a synthetic PFlow_742 (742,793 rows, Poisson(50) entries a row
  clipped to [1, 137], uniform columns) by 16 columns in f32 and bf16,
  beside ``torch.sparse.mm`` and ``F.embedding_bag`` (the same CSR
  product in one call) in f32; then in f32 with the same row lengths but
  columns drawn from the first 100,000 and 371,000 rows of B (B of 6.4
  and 23.7 MB against 47.5), which shows how much of SpMM's time is B
  missing the 50 MB L2.

Needs a CUDA card: exits 2 without one.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SAMPLES = 15
SPIN_CYCLES = 1_000_000   # ~1 ms of card time before each timed call


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA card", flush=True)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6 as rw

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(SAMPLES):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    out = {"root": str(root)}
    q, k, v = (randn(4, h, 2040, 256) for h in (16, 1, 1))
    out["flash_f32_d256_ms"] = time_ms(
        lambda: fa.flash_attention(q, k, v, window=2048))
    out["sdpa_f32_d256_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True))
    del q, k, v
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        r_, k_, v_ = (randn(4, 512, 40, 64, scale=0.5, dtype=dtype)
                      for _ in range(3))
        w_ = (0.97 + 0.029 * torch.rand((4, 512, 40, 64), generator=gen,
                                        device=dev)).to(dtype)
        u_ = randn(40, 64, scale=0.1, dtype=dtype)
        out[f"wkv_{tag}_ms"] = time_ms(
            lambda: rw.rwkv6_scan(r_, k_, v_, w_, u_))
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(40):
                rw.rwkv6_scan(r_, k_, v_, w_, u_)
            host.append((time.perf_counter() - t0) / 40 * 1e6)
        torch.cuda.synchronize()
        out[f"wkv_{tag}_host_us_per_call"] = statistics.median(host)
    del r_, k_, v_, w_, u_

    from repro_torch.core import ops, pipeline
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.tracer import TensorSpec
    from repro_torch.kernels import generic
    from repro_torch.kernels import spmm as sm
    from repro_torch.kernels import spmv as sv
    for name, fn, shape in (("silu_mul", lambda g, u: ops.silu(g) * u,
                             (2048, 8960)),
                            ("add", lambda a, b: a + b, (2048, 1536))):
        spec = TensorSpec(shape, "float32")
        mod = pipeline.compile(fn, spec, spec,
                               options=CompileOptions(target="cuda"))
        (op,) = [o for o in mod.graph.ops
                 if o.opname == "kokkos.team_parallel"]
        region = op.regions[0] if op.regions else generic.one_op_region(op)
        block = op.attrs["tiling"]["block"]
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            a_, b_ = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            out[f"{name}_{tag}_ms"] = time_ms(
                lambda: generic.block_map_region(region, [a_, b_], shape,
                                                 dtype, block=block))
            if name == "add":
                out[f"torch_add_{tag}_ms"] = time_ms(lambda: torch.add(a_,
                                                                       b_))
    n = 742_793
    lens = torch.poisson(torch.full((n,), 50.0, device=dev),
                         generator=gen).clamp_(1, 137).to(torch.int32)
    ip = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    ip[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    cols = torch.randint(0, n, (int(ip[-1]),), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn(cols.shape, generator=gen, device=dev)
    bv = randn(n, 16)
    tiling = sv.default_tiling(n, int(cols.numel()))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a = sv.CsrMatrix(ip, cols, vals.to(dtype), n, n)
        b_ = bv.to(dtype)
        out[f"spmm_{tag}_ms"] = time_ms(
            lambda: sm.spmm_sparse(a, b_, tiling=tiling))
    lib_a = torch.sparse_csr_tensor(ip, cols, vals, size=(n, n))
    out["sparse_mm_f32_ms"] = time_ms(lambda: torch.sparse.mm(lib_a, bv))
    out["embedding_bag_f32_ms"] = time_ms(
        lambda: F.embedding_bag(cols, bv, ip, mode="sum",
                                per_sample_weights=vals,
                                include_last_offset=True))
    for rows in (100_000, 371_000):
        a = sv.CsrMatrix(ip, torch.randint(0, rows, cols.shape, generator=gen,
                                           device=dev, dtype=torch.int32),
                         vals, n, rows)
        b_ = bv[:rows].contiguous()
        out[f"spmm_f32_b{rows}_ms"] = time_ms(
            lambda: sm.spmm_sparse(a, b_, tiling=tiling))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
