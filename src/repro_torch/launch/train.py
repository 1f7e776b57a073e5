"""Training entry point — the fault-tolerant loop; the port of the
reference's ``launch/train.py``.

Composes every substrate piece: the synthetic pipeline (deterministic,
resumable; batches staged through DualViews), the train step, atomic
checkpointing with lazy DualView staging, straggler watermarks,
preemption handling, and restore-and-retry supervision.  The loop runs
under the ambient ``CompileOptions``: its device (the card unless the
caller asks for the CPU) and its target (hand kernels or the plain
versions).

What differs from the reference: a failed step restores the latest
checkpoint *and its step*, and the loop goes on from there, so the
steps after a restart see the batches and the state an uninterrupted
run saw (the reference retries the failed step's batch on the restored
state); ``losses`` keeps one entry a step, the last taken.  The loop
also returns each step's wall time.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.options import (CompileOptions, current_options,
                                      use_options)
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import PreemptionHandler, Retrier, StragglerDetector


def build_trainer(cfg, hp: steps_mod.TrainHParams):
    """→ (model, train step)."""
    model = build_model(cfg)
    return model, steps_mod.make_train_step(model, hp)


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               hp: Optional[steps_mod.TrainHParams] = None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
               seed: int = 0, log_every: int = 10,
               inject_failure_at: Optional[int] = None) -> dict:
    """Returns {"losses": [...], "restarts": n, "stragglers": [...],
    "step_ms": [...]}."""
    device = current_options().resolve_device()
    hp = hp or steps_mod.TrainHParams(
        optimizer=OptimizerConfig(total_steps=steps, warmup_steps=max(
            steps // 20, 1)))
    model, step_fn = build_trainer(cfg, hp)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed), device=device)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    # --- restore or init ----------------------------------------------------
    start_step = 0
    if mgr is not None and mgr.latest() is not None:
        state, start_step = mgr.restore(device=device)
        print(f"[train] restored step {start_step} from {ckpt_dir}")
    else:
        state = steps_mod.init_train_state(model, hp, seed, device)

    straggler = StragglerDetector()
    preempt = PreemptionHandler(install=ckpt_dir is not None)
    retrier = Retrier(max_retries=2)
    losses, step_ms = [], []
    restarts = 0
    step = start_step

    def on_failure(e, attempt):
        """Node-failure model: restore the last checkpoint and go on from
        its step."""
        nonlocal state, step, restarts
        restarts += 1
        if mgr is None or mgr.latest() is None:
            raise e
        state, step = mgr.restore(device=device)
        del losses[step - start_step:], step_ms[step - start_step:]
        print(f"[train] step failed ({e!r}); restored step {step}, retry "
              f"{attempt}")

    def do_step():
        nonlocal inject_failure_at
        if step == inject_failure_at:
            inject_failure_at = None       # fail the first attempt only
            raise RuntimeError("injected node failure")
        b = {k: dv.device() for k, dv in data.batch_dualview(step).items()}
        return step_fn(state, b)

    while step < steps:
        straggler.start_step()
        t0 = time.perf_counter()
        state, metrics = retrier.run(do_step, on_failure)
        loss = float(metrics["loss"])      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        slow = straggler.end_step(step)
        if slow:
            print(f"[train] straggler: step {step} {slow:.1f}x watermark")
        losses.append(loss)
        if log_every and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        step += 1
        if mgr is not None and ckpt_every and step % ckpt_every == 0:
            mgr.save(step, state)
        if preempt.requested:
            print("[train] preemption requested — checkpoint and exit")
            if mgr is not None:
                mgr.save(step, state)
            break
    if mgr is not None and step >= steps:
        mgr.save(step, state)
    preempt.uninstall()
    return {"losses": losses, "restarts": restarts,
            "stragglers": straggler.flagged, "step_ms": step_ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2-1.5b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--remat", default="none")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the state, the batches and the kernels run")
    args = p.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    hp = steps_mod.TrainHParams(
        optimizer=OptimizerConfig(total_steps=args.steps,
                                  warmup_steps=max(args.steps // 20, 1)),
        remat_policy=args.remat, microbatches=args.microbatches)
    with use_options(CompileOptions(device=args.device)):
        out = train_loop(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, hp=hp, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    l = out["losses"]
    print(f"[train] done. loss {l[0]:.4f} → {l[-1]:.4f} "
          f"(restarts={out['restarts']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
