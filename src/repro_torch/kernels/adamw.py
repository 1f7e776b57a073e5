"""Fused AdamW: one optimizer step over a list of leaves in one pass each.

:func:`adamw` launches ``csrc/adamw.cu`` on CUDA tensors: per leaf one
kernel sums the squares of the gradient into per-block partials, one
single-block kernel turns them into the step's coefficients (gradient
norm, clip scale, learning rate, bias corrections, step + 1) on the
card, and per leaf one kernel reads g, p, m and v once and writes the new
p, m and v once: 2 × leaves + 1 launches, no host synchronisation, new
tensors out (the update stays functional).  On CPU tensors it runs the
plain version, :func:`plain`: the reference's AdamW in plain torch
(:func:`plain_coefficients`, then :func:`plain_leaf` a leaf), which the
kernels repeat operation by operation.  Without clipping the two agree
bit for bit on the card; with clipping, to the norm's order of
summation.  ``optim.optimizer.opt_update`` calls :func:`adamw` when every
leaf is a plain tensor, and :func:`plain` itself for DTensors and meta
tensors.

The divides by a host scalar in the schedule are passed as f32
reciprocals, because torch's CUDA kernels multiply by one there; every
other constant goes over as the f32 that torch's kernels take for the
Python float.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256           # threads a block of the norm and update kernels
BLOCKS_PER_SM = 8       # 2048 threads an SM: the SM's full residency


def adamw_kernel() -> _build.KernelSource:
    """The build record of ``csrc/adamw.cu``."""
    return _build.KernelSource("adamw", _build.csrc("adamw.cu"))


def blocks_for(n: int, sm_count: int) -> int:
    """The grid of a leaf of ``n`` entries: a thread per 8 entries up to
    ``BLOCKS_PER_SM`` blocks an SM, then grid-stride.  It depends on the
    size alone, so a leaf's norm partials are summed in the same order in
    every run."""
    return min(-(-n // (8 * THREADS)), BLOCKS_PER_SM * sm_count)


@functools.cache
def _lib():
    lib = _build.load(adamw_kernel())
    ptr, f32, i32, lng = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_long)
    lib.lapis_adamw_norm.argtypes = [ptr, i32, lng, i32, ptr, ptr]
    lib.lapis_adamw_coef_launch.argtypes = \
        [ptr, lng, ptr, ptr, ptr] + [f32] * 10 + [i32, ptr]
    lib.lapis_adamw_update.argtypes = \
        [ptr, i32, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, lng, i32,
         ptr] + [f32] * 6 + [ptr]
    for fn in (lib.lapis_adamw_norm, lib.lapis_adamw_coef_launch,
               lib.lapis_adamw_update):
        fn.restype = ctypes.c_int
    return lib


def _check(params, grads, ms, vs, step) -> None:
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"adamw: {len(params)} params, {len(grads)} grads, "
                         f"{len(ms)} first and {len(vs)} second moments")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adamw: leaf {i}: param {tuple(p.shape)}, grad "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                             f"{tuple(v.shape)}")
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES or \
                m.dtype not in _DTYPES or v.dtype != m.dtype:
            raise TypeError(f"adamw: leaf {i}: param {p.dtype}, grad "
                            f"{g.dtype}, m {m.dtype}, v {v.dtype}; the "
                            "kernel takes float32 or bfloat16, m and v in "
                            "one type")
    if step.dtype != torch.int32 or step.numel() != 1:
        raise TypeError(f"adamw: step {step.dtype} of {step.numel()} "
                        "entries; the kernel takes one int32")


def plain_coefficients(grads, step, hp) -> tuple:
    """The step's coefficients in plain torch, as ``lapis_adamw_coef``
    computes them: (grad_norm, clip scale, step + 1, lr, 1 - b1^t,
    1 - b2^t); the gradients are cast to f32 one at a time."""
    from repro_torch.optim import optimizer   # it imports this module
    gnorm = optimizer.global_norm(grads)
    step = step + 1
    return (gnorm, optimizer.clip_scale(gnorm, hp), step,
            optimizer.lr_at(step, hp),
            1 - hp.b1 ** step.to(torch.float32),
            1 - hp.b2 ** step.to(torch.float32))


def plain_leaf(p, g, m, v, coef, hp) -> tuple:
    """One leaf's update in plain torch, as ``lapis_adamw_update``
    computes it, given :func:`plain_coefficients`' ``coef`` and the f32
    gradient: (new p, new m, new v)."""
    _, scale, _, lr, bc1, bc2 = coef
    b1, b2 = hp.b1, hp.b2
    g = g * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mh = m / bc1
    vh = v / bc2
    pf = p.to(torch.float32)
    return (pf - lr * (mh / (torch.sqrt(vh) + hp.eps)
                       + hp.weight_decay * pf)).to(p.dtype), m, v


def plain(params, grads, ms, vs, step, hp) -> tuple:
    """``optim.optimizer``'s AdamW step in plain torch over aligned lists
    of leaves: (new params, new m, new v, step + 1, grad_norm, lr)."""
    grads = [g.to(torch.float32) for g in grads]
    coef = plain_coefficients(grads, step, hp)
    new_p, new_m, new_v = zip(*(plain_leaf(p, g, m, v, coef, hp)
                                for p, g, m, v in zip(params, grads, ms, vs)))
    gnorm, _, step, lr, _, _ = coef
    return list(new_p), list(new_m), list(new_v), step, gnorm, lr


def adamw(params, grads, ms, vs, step, hp) -> tuple:
    """One AdamW step (``hp``: an ``OptimizerConfig``) over aligned lists
    of leaves → (new params, new m, new v, step + 1, grad_norm, lr), as
    :func:`plain`.  Gradients in float32 or bfloat16 (read as they are),
    masters in either, m and v in either (one type; bf16 only before a
    bf16 master's first step); the new moments are float32, the new
    params in their old type, ``step`` a 0-d int32 tensor."""
    _check(params, grads, ms, vs, step)
    if _build.on_cpu([*params, *grads, *ms, *vs, step], "adamw"):
        adamw.plain_calls += 1
        return plain(params, grads, ms, vs, step, hp)
    dev = step.device
    if any(t.device != dev for t in (*params, *grads, *ms, *vs)):
        raise ValueError("adamw: leaves on more than one card")
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    leaves = [tuple(t.contiguous() for t in q)
              for q in zip(params, grads, ms, vs)]
    blocks = [blocks_for(p.numel(), sms) for p, _, _, _ in leaves]
    partial = torch.empty(max(sum(blocks), 1), dtype=torch.float32,
                          device=dev)
    at = 0
    for (_, g, _, _), b in zip(leaves, blocks):
        if b:
            _build.check(lib.lapis_adamw_norm(
                g.data_ptr(), g.dtype == torch.bfloat16, g.numel(), b,
                partial.data_ptr() + 4 * at, stream), "adamw norm")
            adamw.launches += 1
            at += b
    coef = torch.empty(5, dtype=torch.float32, device=dev)
    new_step = torch.empty((), dtype=torch.int32, device=dev)
    warmup = max(hp.warmup_steps, 1)
    decay = max(hp.total_steps - hp.warmup_steps, 1)
    _build.check(lib.lapis_adamw_coef_launch(
        partial.data_ptr(), at, step.data_ptr(), new_step.data_ptr(),
        coef.data_ptr(), hp.lr, float(np.float32(1) / np.float32(warmup)),
        hp.warmup_steps, float(np.float32(1) / np.float32(decay)), math.pi,
        hp.min_lr_ratio, 1 - hp.min_lr_ratio, hp.b1, hp.b2, hp.clip_norm,
        bool(hp.clip_norm), stream), "adamw coefficients")
    adamw.launches += 1
    new_p, new_m, new_v = [], [], []
    for (p, g, m, v), b in zip(leaves, blocks):
        op = torch.empty(p.shape, dtype=p.dtype, device=dev)
        om = torch.empty(p.shape, dtype=torch.float32, device=dev)
        ov = torch.empty(p.shape, dtype=torch.float32, device=dev)
        if b:
            _build.check(lib.lapis_adamw_update(
                g.data_ptr(), g.dtype == torch.bfloat16, p.data_ptr(),
                p.dtype == torch.bfloat16, m.data_ptr(), v.data_ptr(),
                m.dtype == torch.bfloat16, op.data_ptr(), om.data_ptr(),
                ov.data_ptr(), p.numel(), b, coef.data_ptr(), hp.b1,
                1 - hp.b1, hp.b2, 1 - hp.b2, hp.eps, hp.weight_decay,
                stream), "adamw update")
            adamw.launches += 1
        new_p.append(op)
        new_m.append(om)
        new_v.append(ov)
    return new_p, new_m, new_v, new_step, coef[0], coef[1]


adamw.launches = 0
adamw.plain_calls = 0
