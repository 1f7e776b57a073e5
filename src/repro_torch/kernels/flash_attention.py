"""Flash attention forward — the port of the reference's
``kernels/flash_attention.py`` (the monolithic prefill's attention).

:func:`flash_attention` launches ``csrc/flash_attention.cu`` on CUDA
tensors: one thread block per (batch · query head, 64-query tile) loops
over 64-position K/V tiles staged in shared memory as f32, with an
online softmax in f32.  GQA reads KV head h // (Hq / Hkv); tiles wholly
above the causal diagonal or before the sliding window are skipped;
Sq != Skv, padded tails and a tanh logit softcap are supported.  Q, K
and V are read through their batch, head and position strides (the head
dim contiguous), so the model's (B, S, H, D) → (B, H, S, D) transposes
cost no copy.  On CPU tensors the wrapper runs the plain version
(``ref.attention``); the backward is the plain version's
(``kernels/ops.py``'s ``_Kernelized``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256       # head dims 16, 32, ..., 256
MAX_BATCH_HEADS = 65535  # grid.y limit
_FNS = {torch.float32: "lapis_flash_attention_f32",
        torch.bfloat16: "lapis_flash_attention_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def flash_attention_kernel() -> _build.KernelSource:
    """The build record of ``csrc/flash_attention.cu``."""
    return _build.KernelSource("flash_attention",
                               _build.csrc("flash_attention.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(flash_attention_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against "
                         f"k/v {tuple(k.shape)}")
    if D % 16 or D > MAX_HEAD_DIM or B * Hq > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: head dim {D} (a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}) and {B * Hq} batch heads "
                         f"(at most {MAX_BATCH_HEADS})")
    if q.dtype not in _FNS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}; the kernel takes float32 or bfloat16 "
                        "throughout")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q's
    dtype."""
    if _build.on_cpu([q, k, v], "flash_attention"):
        flash_attention.plain_calls += 1
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale, logit_softcap=logit_softcap)
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    fn = _launcher(q.dtype)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_long * 9)(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Hq, Hkv, Sq, Skv, D, ctypes.cast(strides,
                                                        ctypes.c_void_p),
                    int(causal), -1 if window is None else int(window),
                    float(scale), float(logit_softcap or 0.0),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain_calls = 0
