"""Single-token decode attention — the port of the reference's
``kernels/decode_attention.py`` (the serving step's hot loop).

Decode is cache streaming: one query token per row reads its valid
prefix of the (B, Hkv, S, hd) KV cache.  :func:`decode_attention`
launches ``csrc/decode_attention.cu`` on CUDA tensors: the positions of
each (row, KV head) are split into chunks, enough of them to give the
card about two blocks per SM; a thread block sweeps one chunk's valid
positions with 8 warps, each keeping an online softmax for a group of
the rep = Hq / Hkv query heads (8 of them up to head dim 128, 4 above),
merged in shared memory, and a second kernel merges the chunks of a
row.  K and V may be broadcast over the batch with
stride 0 (the chunked prefill hands C query rows one gathered row);
the kernel reads them through their strides, so nothing is copied.
On CPU tensors the wrapper runs the plain version (``ref.decode_attention``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256
SPLIT_BLOCKS = 2 * 132   # blocks to aim for: two per H100 SM
MIN_CHUNK = 128          # positions a block sweeps at the least
_FNS = {torch.float32: "lapis_decode_attention_f32",
        torch.bfloat16: "lapis_decode_attention_bf16"}
_LAUNCHERS: dict = {}     # dtype (or "heads_per_block") -> ctypes function


def decode_attention_kernel() -> _build.KernelSource:
    """The build record of ``csrc/decode_attention.cu``."""
    return _build.KernelSource("decode_attention",
                               _build.csrc("decode_attention.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(decode_attention_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_long] * 8 + [ctypes.c_int, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def heads_per_block(d: int) -> int:
    """The query heads one block keeps in registers at head dim ``d``,
    asked of ``csrc/decode_attention.cu``, whose launcher picks them
    (here it sizes the split plan's grid)."""
    fn = _LAUNCHERS.get("heads_per_block")
    if fn is None:
        fn = _build.load(decode_attention_kernel()) \
            .lapis_decode_attention_heads_per_block
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        _LAUNCHERS["heads_per_block"] = fn
    return fn(d)


def split_plan(rows: int, positions: int) -> tuple:
    """(number of chunks, positions per chunk) for ``rows`` (row, KV
    head, query-head group) triples over ``positions`` cached positions:
    chunks of at least
    ``MIN_CHUNK`` positions (a multiple of the 32 a block scores per
    sweep), as many as bring the grid to about ``SPLIT_BLOCKS``."""
    def ceil(a, b):
        return -(-a // b)
    want = max(1, min(ceil(positions, MIN_CHUNK),
                      ceil(SPLIT_BLOCKS, max(rows, 1))))
    chunk = max(32, ceil(ceil(positions, want), 32) * 32)
    return max(1, ceil(positions, chunk)), chunk


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, Hkv, _, Dk = k_cache.shape
    if Bk != B or Dk != D or Hq % Hkv or tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {D} (at most "
                         f"{MAX_HEAD_DIM})")
    if q.dtype not in _FNS or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype or lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: q {q.dtype}, caches "
                        f"{k_cache.dtype} / {v_cache.dtype}, lengths "
                        f"{lengths.dtype}; the kernel takes float32 or "
                        "bfloat16 throughout and int32 lengths")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) int32 →
    (B, Hq, D) in q's dtype."""
    if _build.on_cpu([q, k_cache, v_cache, lengths], "decode_attention"):
        decode_attention.plain_calls += 1
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, scale=scale)
    _check(q, k_cache, v_cache, lengths)
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if q.stride(2) != 1:
        q = q.contiguous()
    if k_cache.stride(3) != 1:
        k_cache = k_cache.contiguous()
    if v_cache.stride(3) != 1:
        v_cache = v_cache.contiguous()
    fn = _launcher(q.dtype)
    lengths = lengths.contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rep = Hq // Hkv
    groups = -(-rep // heads_per_block(D))
    n_splits, chunk = split_plan(B * Hkv * groups, S)
    part_ml = part_acc = None
    if n_splits > 1:    # each chunk's (m, l) and unnormalized acc, in f32
        part_ml = torch.empty((B * Hkv, n_splits, rep, 2),
                              dtype=torch.float32, device=q.device)
        part_acc = torch.empty((B * Hkv, n_splits, rep, D),
                               dtype=torch.float32, device=q.device)
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(),
                    0 if part_ml is None else part_ml.data_ptr(),
                    0 if part_acc is None else part_acc.data_ptr(),
                    B, Hkv, rep, S, D, q.stride(0), q.stride(1),
                    *k_cache.stride()[:3], *v_cache.stride()[:3],
                    -1 if window is None else int(window), float(scale),
                    n_splits, chunk,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
