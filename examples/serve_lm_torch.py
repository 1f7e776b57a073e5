"""Batched serving example on the torch port: prefill + batched decode of
a reduced model, with an optional int8-quantized KV cache, through the
hand kernels (the card) or their plain versions (the CPU).

    PYTHONPATH=src python examples/serve_lm_torch.py --quantized-kv
    PYTHONPATH=src python examples/serve_lm_torch.py --arch grok-1-314b \\
        --device cpu
"""
import argparse

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.core.options import CompileOptions, use_options
from repro_torch.launch.serve import serve_loop
from repro_torch.models.model import build_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="qwen2-1.5b",
                   help="one of: " + ", ".join(all_arch_ids()))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--quantized-kv", action="store_true")
    args = p.parse_args(argv)

    options = CompileOptions(target="cuda", device=args.device)
    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg)
    params = model.init(0, options.resolve_device(),
                        dtype=cfg.compute_dtype)
    with use_options(options):
        out = serve_loop(model, params, n_requests=args.requests,
                         batch=args.batch, prompt_len=args.prompt_len,
                         gen_len=args.gen_len, quantized=args.quantized_kv)
    print(f"[example] served {out['requests']} requests "
          f"({out['tokens']} tokens) at {out['tok_per_s']:.1f} tok/s "
          f"(kv cache: {'int8' if args.quantized_kv else 'bf16'})")


if __name__ == "__main__":
    main()
