"""RG-LRU scan (recurrentgemma / Griffin) — the port of the reference's
``kernels/rglru.py`` (the recurrent blocks of the hybrid family).

:func:`rglru_scan` launches ``csrc/rglru.cu`` on CUDA tensors: a
segmented scan.  Time is cut into segments of a few steps, one a thread
(8 bf16 or 4 f32 channels a step, read by 16-byte vectors along the
channels, the coefficients kept in registers); a block combines its
segments by shuffles and one shared-memory exchange, and the blocks'
tiles along T hand each other their end h through an f32 scratch in a
fixed order.  Each segment then re-runs its steps from its true starting
h and writes y in x's dtype; the final h is f32.  A resident grid walks
the tiles, copying the next tile into a shared ring by ``cp.async``
while it computes the current one.  Unlike the TPU kernel it takes an
initial h, so the serving decode step (T = 1 against the cached h) runs
the kernel too, as one segment a thread and a channel a thread.
:func:`rglru_plan` is the launch plan (the twin of ``plan`` in the
source, held to it on the card).  On CPU tensors the wrapper runs the
plain version (``ref.rglru_scan``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_BATCH = 65535    # what the launcher takes (its grid is 1-D)
THREADS = 256        # most threads a block
BLOCKS_PER_SM = 2    # resident blocks of THREADS an SM
MAX_CHAIN = 16       # most chunks the fill rule makes along T
PLAN_FIELDS = ("vec", "steps", "lanes", "segs", "threads", "chunks",
               "colgroups", "tickets", "grid")
_FNS = {torch.float32: "lapis_rglru_f32", torch.bfloat16: "lapis_rglru_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function
_SMS: dict = {}           # device index -> SM count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rglru_plan(batch: int, t_len: int, d: int, dtype: torch.dtype,
               sm_count: int, aligned: bool = True) -> dict:
    """The launch of a (batch, t_len, d) scan in ``dtype`` on a card of
    ``sm_count`` SMs (``aligned``: x, r, i and y 16-byte aligned) — the
    twin of ``plan`` in ``csrc/rglru.cu``.  ``vec`` channels a thread a
    step (a 16-byte vector, or 1 off the vector), ``steps`` steps a
    segment, ``lanes`` threads along D and ``segs`` segments (consecutive
    in time) a block of ``threads``; ``chunks`` tiles along T (each
    ``segs * steps`` steps), ``colgroups`` along D: ``tickets`` = batch x
    colgroups x chunks tiles, walked by ``grid`` resident blocks
    (``BLOCKS_PER_SM`` of ``THREADS`` an SM, or as many smaller ones as
    take their place).  A T of one segment runs one segment a thread;
    the decode step's T = 1 also reads a channel a thread (``vec`` 1)."""
    v16 = 16 // dtype.itemsize
    # the decode step (T <= 1) is latency: a channel a thread
    vec = v16 if aligned and d % v16 == 0 and t_len > 1 else 1
    smax = 4 if vec > 1 else 8
    vcols = _cdiv(d, vec)
    steps = 1
    while steps < smax and steps < t_len:
        steps *= 2
    lanes, segs = 32, 1
    if t_len > steps:
        lanes = 8 if vec > 1 else 32
        while lanes > 1 and lanes // 2 >= vcols:
            lanes //= 2
        nseg = _cdiv(t_len, steps)
        segs = 32 // lanes
        while segs < THREADS // lanes and segs < nseg:
            segs *= 2
        # long T over few channels: shorter chunks, so the blocks fill
        # the SMs, while the chain of chunks stays at most MAX_CHAIN long
        while segs > 32 // lanes and batch * _cdiv(vcols, lanes) * \
                _cdiv(t_len, segs * steps) < sm_count and \
                _cdiv(t_len, segs // 2 * steps) <= MAX_CHAIN:
            segs //= 2
    chunks = _cdiv(t_len, segs * steps) if t_len > 0 else 1
    colgroups = _cdiv(vcols, lanes)
    tickets = batch * colgroups * chunks
    return dict(vec=vec, steps=steps, lanes=lanes, segs=segs,
                threads=lanes * segs, chunks=chunks, colgroups=colgroups,
                tickets=tickets,
                grid=min(tickets, sm_count * BLOCKS_PER_SM *
                         (THREADS // (lanes * segs))))


def c_plan(batch: int, t_len: int, d: int, dtype: torch.dtype,
           sm_count: int, aligned: bool = True) -> dict:
    """The plan the library's exported ``lapis_rglru_plan`` computes, in
    :func:`rglru_plan`'s form (builds the library)."""
    fn = _build.load(rglru_kernel()).lapis_rglru_plan
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = fn(batch, t_len, d, dtype.itemsize, int(aligned), sm_count, out)
    if rc != 0:
        raise ValueError(f"lapis_rglru_plan({batch}, {t_len}, {d}): "
                         f"error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def rglru_kernel() -> _build.KernelSource:
    """The build record of ``csrc/rglru.cu``."""
    return _build.KernelSource("rglru", _build.csrc("rglru.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(rglru_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong,
                                               ctypes.c_void_p,
                                               ctypes.c_longlong] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _check(x, r_gate, i_gate, log_a_param, state) -> None:
    if x.ndim != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, r "
                         f"{tuple(r_gate.shape)}, i {tuple(i_gate.shape)}")
    B, _, D = x.shape
    if tuple(log_a_param.shape) != (D,) or B > MAX_BATCH or \
            (state is not None and tuple(state.shape) != (B, D)):
        got = None if state is None else tuple(state.shape)
        raise ValueError(f"rglru_scan: log_a {tuple(log_a_param.shape)}, "
                         f"state {got} against (B, D) = {(B, D)} (B at "
                         f"most {MAX_BATCH})")
    if x.dtype not in _FNS or any(t.dtype != x.dtype for t in
                                  (r_gate, i_gate, log_a_param)) or \
            (state is not None and state.dtype != torch.float32):
        raise TypeError(f"rglru_scan: x/r/i {x.dtype}, {r_gate.dtype}, "
                        f"{i_gate.dtype}, log_a {log_a_param.dtype}; the "
                        "kernel takes float32 or bfloat16 throughout (as "
                        "cast_compute leaves the parameters) and an f32 "
                        "state")


def rglru_scan(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               log_a_param: torch.Tensor,
               state: Optional[torch.Tensor] = None) -> tuple:
    """x, r_gate, i_gate: (B, T, D); log_a_param: (D,); state: (B, D) f32
    or None → (y (B, T, D) in x's dtype, final h (B, D) f32)."""
    tensors = [x, r_gate, i_gate, log_a_param] + \
        ([] if state is None else [state])
    if _build.on_cpu(tensors, "rglru_scan"):
        rglru_scan.plain_calls += 1
        return ref.rglru_scan(x, r_gate, i_gate, log_a_param, state)
    _check(x, r_gate, i_gate, log_a_param, state)
    B, T, D = x.shape
    x, r_gate, i_gate, log_a_param = (
        t.contiguous() for t in (x, r_gate, i_gate, log_a_param))
    if state is not None:
        state = state.contiguous()
    fn = _launcher(x.dtype)
    y = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    h = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0 or D == 0:
        return y, h
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, r_gate, i_gate, y))
    plan = rglru_plan(B, T, D, x.dtype, _sm_count(x.device), aligned)
    carry = flags = None
    if plan["chunks"] > 1:      # the chunks' end h, and their flags
        carry = torch.empty((B, plan["chunks"] - 1, D), dtype=torch.float32,
                            device=x.device)
        flags = torch.zeros(1 + B * plan["colgroups"] * (plan["chunks"] - 1),
                            dtype=torch.int32, device=x.device)
    _build.check(fn(x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
                    log_a_param.data_ptr(),
                    0 if state is None else state.data_ptr(), y.data_ptr(),
                    h.data_ptr(), 0 if carry is None else carry.data_ptr(),
                    0 if carry is None else carry.numel(),
                    0 if flags is None else flags.data_ptr(),
                    0 if flags is None else flags.numel(), B, T, D,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "rglru_scan")
    rglru_scan.launches += 1
    return y, h


rglru_scan.launches = 0
rglru_scan.plain_calls = 0
