"""End-to-end training example on the torch port: a reduced LM for a few
hundred steps through the full stack — the synthetic pipeline, the
train step (microbatched, remat), checkpoint / restart, straggler
watermarks — on the card, or on the CPU with ``--device cpu``.

``--full-100m`` selects the ~100M-parameter qwen2 configuration (the
same code path at larger widths).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --arch grok-1-314b \\
        --steps 20 --device cpu
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.core.options import CompileOptions, use_options
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import train_loop
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig


def hundred_m_config():
    """qwen2-family ~100M: 12L × 512 × 8H(kv2) × ffn 2048, 32k vocab."""
    base = get_config("qwen2-1.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=2, d_ff=2048, vocab_size=32000, head_dim=64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="qwen2-1.5b",
                   help="the reduced config of one of: "
                        + ", ".join(all_arch_ids()))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--full-100m", action="store_true")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: a temporary one)")
    args = p.parse_args(argv)

    cfg = hundred_m_config() if args.full_100m else \
        get_config(args.arch, reduced=True)
    print(f"[example] {cfg.name}: {build_model(cfg).n_params():,} params")
    hp = steps_mod.TrainHParams(
        optimizer=OptimizerConfig(lr=3e-3, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 20, 1)),
        microbatches=2, remat_policy="nothing")
    with tempfile.TemporaryDirectory(prefix="lapis_train_lm_") as tmp, \
            use_options(CompileOptions(target="cuda", device=args.device)):
        out = train_loop(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, hp=hp,
                         ckpt_dir=args.ckpt_dir or tmp,
                         ckpt_every=max(args.steps // 4, 1), log_every=20)
    l = out["losses"]
    print(f"[example] loss {l[0]:.4f} → {l[-1]:.4f} over {len(l)} steps "
          f"(restarts={out['restarts']}, "
          f"stragglers={len(out['stragglers'])})")
    assert l[-1] < l[0], "loss must decrease on structured data"


if __name__ == "__main__":
    main()
