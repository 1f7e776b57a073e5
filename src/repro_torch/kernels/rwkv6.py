"""RWKV6 (Finch) WKV scan — the port of the reference's
``kernels/rwkv6.py`` (the prefill of the rwkv family).

:func:`rwkv6_scan` launches ``csrc/rwkv6.cu`` on CUDA tensors: one thread
block per (batch, head) walks time with the f32 (K, V) state in
registers, four threads per state column, and writes y and the final
state.  Unlike the TPU kernel it takes an initial state and returns the
final one, so the serving prefill gets its decode state from the same
launch.
r, k, v and w are read through their (batch, time, head) strides.  On
CPU tensors the wrapper runs the plain version (``ref.rwkv6_scan``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_K = 128          # state rows: each thread keeps a quarter in registers
MAX_V = 256          # four threads per state column, 1024 a block
_FNS = {torch.float32: "lapis_rwkv6_f32", torch.bfloat16: "lapis_rwkv6_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def rwkv6_kernel() -> _build.KernelSource:
    """The build record of ``csrc/rwkv6.cu``."""
    return _build.KernelSource("rwkv6", _build.csrc("rwkv6.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(rwkv6_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _check(r, k, v, w, u, state) -> None:
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape or \
            v.ndim != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}")
    B, _, H, K = r.shape
    V = v.shape[3]
    if tuple(u.shape) != (H, K) or (state is not None and
                                    tuple(state.shape) != (B, H, K, V)):
        got = None if state is None else tuple(state.shape)
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} and state {got} "
                         f"against (B, H, K, V) = {(B, H, K, V)}")
    if K > MAX_K or V > MAX_V:
        raise ValueError(f"rwkv6_scan: K = {K} (at most {MAX_K}) and V = {V}"
                         f" (at most {MAX_V})")
    if r.dtype not in _FNS or any(t.dtype != r.dtype for t in (k, v, w, u)) \
            or (state is not None and state.dtype != torch.float32):
        raise TypeError(f"rwkv6_scan: r/k/v/w/u {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}, {u.dtype}; the kernel takes "
                        "float32 or bfloat16 throughout and an f32 state")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None) -> tuple:
    """r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K); state:
    (B, H, K, V) f32 or None → (y (B, T, H, V) in v's dtype, final state
    (B, H, K, V) f32)."""
    tensors = [r, k, v, w, u] + ([] if state is None else [state])
    if _build.on_cpu(tensors, "rwkv6_scan"):
        rwkv6_scan.plain_calls += 1
        return ref.rwkv6_scan(r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    B, T, H, K = r.shape
    V = v.shape[3]
    r, k, v, w = (t if t.stride(3) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    u = u.contiguous()
    if state is not None:
        state = state.contiguous()
    fn = _launcher(r.dtype)
    y = torch.empty((B, T, H, V), dtype=v.dtype, device=v.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=v.device)
    if B == 0:
        return y, s_out
    strides = (ctypes.c_long * 12)(*(s for t in (r, k, v, w)
                                     for s in t.stride()[:3]))
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), 0 if state is None else state.data_ptr(),
                    y.data_ptr(), s_out.data_ptr(), B, H, T, K, V,
                    ctypes.cast(strides, ctypes.c_void_p),
                    torch.cuda.current_stream(v.device).cuda_stream),
                 "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0
rwkv6_scan.plain_calls = 0
