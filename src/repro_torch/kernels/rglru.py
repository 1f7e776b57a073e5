"""RG-LRU scan (recurrentgemma / Griffin) — the port of the reference's
``kernels/rglru.py`` (the recurrent blocks of the hybrid family).

:func:`rglru_scan` launches ``csrc/rglru.cu`` on CUDA tensors: one
thread per (batch, channel), coalesced along the channels, walks time
with h in an f32 register and writes y in x's dtype and the final h.
Unlike the TPU kernel it takes an initial h, so the serving decode step
(T = 1 against the cached h) runs the kernel too.  On CPU tensors the
wrapper runs the plain version (``ref.rglru_scan``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_BATCH = 65535    # grid.y limit
_FNS = {torch.float32: "lapis_rglru_f32", torch.bfloat16: "lapis_rglru_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def rglru_kernel() -> _build.KernelSource:
    """The build record of ``csrc/rglru.cu``."""
    return _build.KernelSource("rglru", _build.csrc("rglru.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(rglru_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
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
    _build.check(fn(x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
                    log_a_param.data_ptr(),
                    0 if state is None else state.data_ptr(), y.data_ptr(),
                    h.data_ptr(), B, T, D,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "rglru_scan")
    rglru_scan.launches += 1
    return y, h


rglru_scan.launches = 0
rglru_scan.plain_calls = 0
