"""Multi-pod dry-run — the port of the reference's ``launch/dryrun.py``.

For every (architecture × input shape × mesh) cell: build the cell's
step, place its arguments as meta DTensors on the production mesh (a
``DeviceMesh`` over a fake process group, ``launch/mesh.py``), run the
step once under ``launch/opcount.py``'s counting mode, and write the
per-device FLOPs, HBM bytes, collective bytes and memory to
``<out>/<cell>.json`` in the reference's record layout.

The roofline terms divide by this host's measured ceilings
(``core.costmodel.load_peaks``, written by ``python -m
repro_torch.benchmarks.machine_peaks`` on the card): the bf16 matrix
rate for compute, the streaming HBM rate for memory.  No TPU constant
carries over.  A record whose peaks are the documented defaults says so
(``peaks.measured`` false).  A link rate cannot be measured on a
one-card host, so ``collective_s`` is null with that reason; the
collective bytes are still recorded.

Memory comes from the abstract trees: arguments and outputs by local
shard bytes, and the peak of live meta-tensor bytes the step made
(``temp_bytes``, the step's outputs included while they live; nothing
is donated, so ``alias_bytes`` is 0).  A cell whose model runs an op
DTensor has no sharding strategy for (or any other failure) is recorded
as ``status: "error"`` with the op in ``error``, as the reference
records a failed compile.

The steps run on the ``torch`` target: the plain versions, through
DTensor's sharding propagation (the reference's dry-run lowers its
library path too).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.core import costmodel
from repro_torch.core.options import CompileOptions, use_options
from repro_torch.dist import sharding as shd
from repro_torch.launch import opcount
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, batch_specs, cell_dims,
                                       cell_supported, decode_specs)
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig

COLLECTIVE_S_REASON = ("no link rate: a one-card host measures no "
                       "interconnect, so the collective term is not "
                       "estimated (its bytes are recorded)")

# the steps run the plain versions (DTensor propagates their shardings)
COUNT_OPTIONS = CompileOptions(target="torch", device="cpu")


def default_hparams(model) -> steps_mod.TrainHParams:
    """The reference's baseline: 8 gradient-accumulation microbatches;
    ≥ 100B params train bf16 master + Adafactor (f32 AdamW state alone
    exceeds a 256-chip pod's memory), the rest f32 master + AdamW."""
    big = model.n_params() >= 100e9
    return steps_mod.TrainHParams(
        optimizer=OptimizerConfig(kind="adafactor" if big else "adamw"),
        remat_policy="nothing",
        master_dtype="bfloat16" if big else "float32",
        microbatches=8)


def cut_depth(cfg, layers: int):
    """``cfg`` with ``layers`` decoder layers (a hybrid: ``layers``
    pattern groups; an encoder-decoder: as many encoder layers too) —
    the widths, and so every op and sharding, unchanged."""
    n = layers * len(cfg.pattern) if cfg.pattern else layers
    kw = {"n_layers": n}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def build_cell(arch: str, shape_name: str, mesh, *,
               hp: Optional[steps_mod.TrainHParams] = None,
               quantized_kv: bool = False, reduced: bool = False,
               layers: Optional[int] = None):
    """→ (run, cfg, model, args): ``run()`` runs the cell's step once on
    its placed meta arguments ``args`` and returns (outputs, counts).
    With a ``DeviceMesh`` the arguments are DTensors; with ``mesh=None``
    they are plain meta tensors (one device).  ``layers`` cuts the depth
    (:func:`cut_depth`: what runs per layer is the cell's)."""
    cfg = get_config(arch, reduced=reduced)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    model = build_model(cfg)
    hp = hp or default_hparams(model)
    kind = SHAPES[shape_name]["kind"]

    def place(tree, shardings):
        return tree if mesh is None else \
            shd.distribute_tree(tree, shardings)

    def sharding_of(fn, *a):
        return None if mesh is None else fn(mesh, *a)

    if kind == "train":
        step = steps_mod.make_train_step(model, hp)
        state = place(steps_mod.abstract_train_state(model, hp),
                      sharding_of(steps_mod.train_state_shardings, model,
                                  hp))
        specs = batch_specs(cfg, shape_name, reduced=reduced)
        batch = place(specs, sharding_of(steps_mod.batch_shardings, specs))
        args = (state, batch)
    elif kind == "prefill":
        specs = batch_specs(cfg, shape_name, reduced=reduced)
        step = steps_mod.make_prefill_step(
            model, max_len=specs["tokens"].shape[1], quantized=quantized_kv)
        params_abs = steps_mod.cast_compute(model.abstract(), "bfloat16")
        params = place(params_abs, sharding_of(
            shd.param_shardings, params_abs, model.axes()))
        batch = place(specs, sharding_of(steps_mod.batch_shardings, specs))
        args = (params, batch)
    elif kind == "decode":
        dstep = steps_mod.make_decode_step(model)
        params_abs = steps_mod.cast_compute(model.abstract(), "bfloat16")
        params = place(params_abs, sharding_of(
            shd.param_shardings, params_abs, model.axes()))
        dspecs = decode_specs(cfg, shape_name, quantized_kv=quantized_kv,
                              reduced=reduced)
        cache = place(dspecs["cache"],
                      sharding_of(steps_mod.cache_shardings,
                                  dspecs["cache"]))
        B = dspecs["token"].shape[0]
        token = dspecs["token"] if mesh is None else shd.distribute(
            dspecs["token"], shd.batch_sharding(mesh, (B,)))
        # the port's decode step takes its position as an int: the
        # cell's last one (the reference's is a traced scalar)
        length = cell_dims(shape_name, reduced)[1] - 1

        def step(params, token, cache):
            return dstep(params, token, cache, length)
        args = (params, token, cache)
    else:
        raise ValueError(kind)

    def run():
        active = shd.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext()
        with active, use_options(COUNT_OPTIONS):
            out, counts = opcount.count(step, *args)
        return out, counts
    return run, cfg, model, args


def model_flops(cfg, model, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    (one token per row)."""
    info = SHAPES[shape_name]
    n = model.n_active_params()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n * tokens
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n * tokens          # forward only
    return 2.0 * n * info["batch"]       # decode: one token per row


def peaks_record(peaks) -> dict:
    """The ceilings a record divides by, and whether they were measured
    on this host (``measured`` false: the documented defaults)."""
    return {"measured": bool(peaks.measured),
            "fingerprint": peaks.fingerprint,
            "bf16_flops_per_s": peaks.bf16_flops_per_s,
            "flops_per_s": peaks.flops_per_s,
            "bandwidth_bytes_per_s": peaks.bandwidth_bytes_per_s,
            "source": ("measured by repro_torch.benchmarks.machine_peaks"
                       if peaks.measured else
                       "costmodel.DEFAULT_PEAKS (not measured on this "
                       "host)")}


def roofline(counts: dict, peaks) -> dict:
    """The compute and memory terms (s) and the dominant one; the
    collective term is null (:data:`COLLECTIVE_S_REASON`)."""
    compute_s = counts["flops"] / peaks.bf16_flops_per_s
    memory_s = counts["bytes"] / peaks.bandwidth_bytes_per_s
    terms = {"compute_s": compute_s, "memory_s": memory_s}
    return {**terms, "collective_s": None,
            "collective_s_reason": COLLECTIVE_S_REASON,
            "dominant": max(terms, key=terms.get)}


def analyse(counts: dict, args, outputs, cfg, model, arch: str,
            shape_name: str, mesh_name: str, n_chips: int,
            elapsed: float, peaks) -> dict:
    coll = counts["collectives"]
    flops = float(counts["flops"])
    mf = model_flops(cfg, model, shape_name)
    arg_b = opcount.tree_bytes(args)
    out_b = opcount.tree_bytes(outputs)
    temp_b = counts["peak_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": n_chips,
        "status": "ok",
        "compile_seconds": round(elapsed, 1),
        "n_params": model.n_params(),
        "n_active_params": model.n_active_params(),
        "flops_per_device": flops,
        "bytes_per_device": float(counts["bytes"]),
        "naive_cost_analysis": {
            "flops": None, "bytes_accessed": None,
            "note": "XLA's cost_analysis has no torch counterpart; the "
                    "counts above run every loop iteration"},
        "collective_bytes_per_device": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k != "total"},
        "collective_counts": counts["collective_counts"],
        "top_bytes": [[f"{b:.3e}", op, comp, name]
                      for b, op, comp, name in counts["top_bytes"][:12]],
        "top_collectives": [[f"{b:.3e}", kind, op, shape, n]
                            for b, kind, op, shape, n
                            in counts["top_collectives"][:12]],
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": 0,
            "total_bytes": arg_b + temp_b,
        },
        "peaks": peaks_record(peaks),
        "roofline": {
            **roofline(counts, peaks),
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_flops_ratio":
                (mf / n_chips) / flops if flops else 0.0,
        },
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, hp=None, quantized_kv=False, tag="", peaks=None) -> dict:
    cfg = get_config(arch)
    ok, reason = cell_supported(cfg, shape_name)
    mesh_name = "multi" if mesh_kind == "multi" else "single"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                      else "")
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        _write(out_dir, cell_id, rec)
        print(f"SKIP {cell_id}: {reason}")
        return rec
    peaks = peaks or costmodel.load_peaks()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = shd.mesh_size(mesh)
    t0 = time.time()
    try:
        run, cfg, model, args = build_cell(arch, shape_name, mesh, hp=hp,
                                           quantized_kv=quantized_kv)
        outputs, counts = run()
        elapsed = time.time() - t0
        rec = analyse(counts, args, outputs, cfg, model, arch, shape_name,
                      mesh_name, n_chips, elapsed, peaks)
        if tag:
            rec["tag"] = tag
        mem = rec["memory"]["total_bytes"]
        dom = rec["roofline"]["dominant"]
        print(f"OK   {cell_id}: {elapsed:.0f}s  "
              f"mem/dev={mem / 2**30:.2f}GiB  dominant={dom}  "
              f"useful={rec['roofline']['useful_flops_ratio']:.2f}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()}
        print(f"FAIL {cell_id}: {e!r}"[:400])
    _write(out_dir, cell_id, rec)
    return rec


def _write(out_dir, cell_id, rec):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--quantized-kv", action="store_true")
    p.add_argument("--tag", default="")
    p.add_argument("--out", default="artifacts/dryrun")
    args = p.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = all_arch_ids() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               quantized_kv=args.quantized_kv,
                               tag=args.tag)
                n_fail += rec.get("status") == "error"
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
