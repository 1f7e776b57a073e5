"""Single-token decode attention — the port of the reference's
``kernels/decode_attention.py`` (the serving step's hot loop).

Decode is cache streaming: one query token per row reads its valid
prefix of the (B, Hkv, S, hd) KV cache.  :func:`decode_attention`
launches ``csrc/decode_attention.cu`` on CUDA tensors: the positions of
each (row, KV head) are split into chunks of whole 64-position tiles,
enough of them to give the card about two blocks per SM
(:func:`split_plan`); a block takes every query head of its KV head
(:func:`launch_plan`), streams its chunk's K and V tiles through a
``cp.async`` ring in shared memory and runs the online softmax on them
— bf16 on the tensor cores (``mma.sync``), f32 on the CUDA cores — and
a second kernel merges the chunks of a row.  A logit cap (grok-1's) turns each scaled score x
into cap · tanh(x / cap) before the softmax.  K and V may be broadcast
over the batch with stride 0 (the chunked prefill hands C query rows
one gathered row); the kernel reads them through their strides, so
nothing is copied.  On CPU tensors the wrapper runs the plain version
(``ref.decode_attention``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256
SPLIT_BLOCKS = 2 * 132   # blocks to aim for: two per H100 SM
TILE = 64                # positions of one ring stage (csrc/decode_attention.cu)
MIN_CHUNK = TILE         # positions a block sweeps at the least
MAX_STAGES = 3
SMEM_LIMIT = 232_448     # dynamic shared memory a block may opt in to
_FNS = {torch.float32: "lapis_decode_attention_f32",
        torch.bfloat16: "lapis_decode_attention_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


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
                                   ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(d: int, rep: int, chunk: int, dtype: torch.dtype) -> dict:
    """The kernel's launch at head dim ``d``, ``rep`` query heads per KV
    head and ``chunk`` positions per split, as ``da_plan`` in
    ``csrc/decode_attention.cu`` computes it (held to it on the card):

    * bf16: the block's query heads as ``mt`` m16 tiles (1, 2 or 4; 2 above
      D = 128), ``heads`` = min(rep, 16·mt) of them and ``groups`` blocks
      over a KV head's query heads (1 up to rep 64); ``wd`` of the four
      warps split O's head dim so a thread keeps at most 128 f32 of it (64
      above one m16 tile); rows of D
      padded to 16 plus 16 bytes; after the last tile the ring holds the
      4 / wd warp groups' O slices for the block's merge;
    * f32: ``heads`` = min(rep, 32, 4096 / D) (a thread holds at most 32
      outputs), rows of D padded to 8 plus 4 floats;
    * ``stages`` of the K / V ring (up to 3, no more than the chunk's tiles
      and than fits ``SMEM_LIMIT``) and the ``smem_bytes`` it all takes."""
    tiles = max(1, _cdiv(chunk, TILE))
    if dtype == torch.bfloat16:
        dp = _cdiv(d, 16) * 16
        row = 2 * dp + 16
        mt_all = _cdiv(rep, 16)
        mt = 1 if mt_all == 1 else 2 if (mt_all == 2 or dp > 128) else 4
        heads = min(rep, 16 * mt)
        ou = (16 if dp > 128 else 8) if mt == 1 else 8 // mt
        wd = 1
        while wd * 16 * ou < dp:
            wd *= 2
        wk = 4 // wd
        fixed = 16 * mt * row      # Q
        merge = 4 * (wk * 16 * mt * (dp + 4) + 2 * wk * 16 * mt + 2 * 16 * mt)
    else:
        dp = _cdiv(d, 8) * 8
        row = 4 * (dp + 4)
        heads = min(rep, 32, 4096 // dp)
        mt = wd = merge = 0
        fixed = 4 * (heads * dp + heads * TILE + 3 * heads)   # Q, P, m / l
    stages = min(MAX_STAGES, tiles)
    while stages > 1 and \
            fixed + max(stages * 2 * TILE * row, merge) > SMEM_LIMIT:
        stages -= 1
    return {"heads": heads, "groups": _cdiv(rep, heads), "mt": mt, "wd": wd,
            "padded_dim": dp, "stages": stages,
            "smem_bytes": fixed + max(stages * 2 * TILE * row, merge)}


def split_plan(rows: int, positions: int) -> tuple:
    """(number of chunks, positions per chunk) for ``rows`` (row, KV
    head, query-head group) triples over ``positions`` cached positions:
    chunks of whole ``TILE``-position ring tiles, at least ``MIN_CHUNK``
    long, as many as bring the grid to about ``SPLIT_BLOCKS``.  It reads
    only shapes, never ``lengths``: the card is not synchronised."""
    want = max(1, min(_cdiv(positions, MIN_CHUNK),
                      _cdiv(SPLIT_BLOCKS, max(rows, 1))))
    chunk = max(TILE, _cdiv(_cdiv(positions, want), TILE) * TILE)
    return max(1, _cdiv(positions, chunk)), chunk


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
                     scale: Optional[float] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) int32 →
    (B, Hq, D) in q's dtype.  ``logit_softcap``: None or 0 for no cap."""
    if _build.on_cpu([q, k_cache, v_cache, lengths], "decode_attention"):
        decode_attention.plain_calls += 1
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, scale=scale,
                                    logit_softcap=logit_softcap)
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
    groups = launch_plan(D, rep, TILE, q.dtype)["groups"]
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
                    float(logit_softcap or 0.0), n_splits, chunk,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
