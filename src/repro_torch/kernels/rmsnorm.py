"""Fused RMSNorm — the port of the reference's ``kernels/rmsnorm.py``.

:func:`rmsnorm` launches ``csrc/rmsnorm.cu`` on CUDA tensors: each row is
read once into registers by 16-byte loads, and x·rsqrt(mean(x²)+eps)·w is
computed in f32 and written in x's dtype.  :func:`rms_plan` is the twin
of the kernel's launch plan (``csrc/row_reduce.cuh``): a warp a row for a
prefill's thousands of rows, a block a row for a decode step's handful,
a block-stride loop for widths the vectors cannot take.
The norm runs twice per layer and once before the head, in prefill
(thousands of rows) and decode (one row per slot) alike; the weight is
in x's dtype there (``cast_compute`` casts every parameter).  On CPU tensors
the wrapper runs the plain version (``ref.rmsnorm``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref, row_reduce

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def rmsnorm_kernel() -> _build.KernelSource:
    """The build record of ``csrc/rmsnorm.cu``."""
    return _build.KernelSource("rmsnorm", _build.csrc("rmsnorm.cu"))


def rms_plan(rows: int, d: int, dtype: torch.dtype, sm_count: int,
             aligned: bool = True) -> dict:
    """The launch ``csrc/rmsnorm.cu`` makes for ``rows`` rows of ``d``
    values of ``dtype`` on a card of ``sm_count`` SMs (``aligned``: x, w
    and out on 16-byte boundaries): :func:`row_reduce.row_plan`."""
    return row_reduce.row_plan(rows, d, dtype.itemsize, aligned, sm_count)


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        lib = _build.load(rmsnorm_kernel())
        fn = getattr(lib, f"lapis_rmsnorm_{_DTYPES[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int,
                                               ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,) → x's shape and dtype."""
    if _build.on_cpu([x, weight], "rmsnorm"):
        rmsnorm.plain_calls += 1
        return ref.rmsnorm(x, weight, eps=eps)
    d = x.shape[-1] if x.ndim else 0
    if d == 0 or tuple(weight.shape) != (d,):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} with weight "
                         f"{tuple(weight.shape)}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x {x.dtype}, weight {weight.dtype}; the "
                        "kernel takes float32 or bfloat16, the weight in "
                        "x's dtype")
    fn = _launcher(x.dtype)
    x, weight = x.contiguous(), weight.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    _build.check(fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                    float(eps),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm.plain_calls = 0
