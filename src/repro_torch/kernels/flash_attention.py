"""Flash attention forward — the port of the reference's
``kernels/flash_attention.py`` (the monolithic prefill's attention).

:func:`flash_attention` routes CUDA tensors by dtype to one of two
kernels, each with its own launch count beside the total:

* **bf16** → ``csrc/flash_attention_sm90.cu`` (``launches_sm90``): one
  block of a TMA producer warpgroup and two ``wgmma`` consumer
  warpgroups per (batch · query head, 128-query tile); K / V tiles come
  through a ring of 128-byte-swizzled shared memory, S = Q·Kᵀ
  and O += P·V run on the tensor cores with f32 accumulators, and the
  online softmax works on the accumulator fragments.  Its tensor maps
  read Q, K and V through their batch, head and position strides, so
  the model's (B, S, H, D) → (B, H, S, D) transposes cost no copy; an
  operand TMA cannot address (:func:`tma_ready`) is copied to fresh
  contiguous storage first and still goes to the kernel.
* **f32** → ``csrc/flash_attention.cu`` (``launches_ffma``): FFMA
  register micro-tiles (8 query rows × 4 keys up to D = 128) fed by
  16-byte shared loads, K and V tiles by ``cp.async`` while the tile
  before computes, two 128-thread blocks an SM up to D = 128
  (:func:`ffma_plan`), the longest causal walks dispatched first; held
  to the f32 bars (2e-4 against the plain version, exact greedy tokens)
  that tensor cores cannot meet.  It reads 16-byte aligned operands in
  place (:func:`async_ready`) and copies any other view first.

Both take GQA (KV head h // (Hq / Hkv)), causal and sliding-window masks
(rectangular causal aligned top-left, as ``ref.attention``), Sq != Skv
with ragged tails, a tanh logit softcap and head dims 16, 32, ..., 256;
both skip KV tiles wholly above the diagonal or before the window, and
write 0 for a row with no valid key.  On CPU tensors the wrapper runs
the plain version (``ref.attention``); the backward is the plain
version's (``kernels/ops.py``'s ``_Kernelized``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256       # head dims 16, 32, ..., 256
MAX_BATCH_HEADS = 65535  # what both launchers take
SMEM_LIMIT = 232_448     # dynamic shared memory a block may opt in to
SM_SMEM = 233_472        # shared memory of an SM (228 KB)
BLOCK_RESERVED = 1_024   # shared memory the card reserves for each block
# the f32 kernel's launch plan (csrc/flash_attention.cu)
FFMA_BLOCK_Q = FFMA_BLOCK_KV = 64
FFMA_PLAN_FIELDS = ("threads", "rows", "block_q", "block_kv", "smem_bytes",
                    "blocks_per_sm")
# the bf16 kernel's launch plan (csrc/flash_attention_sm90.cu)
SM90_BLOCK_Q = 128
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_float, ctypes.c_void_p]
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def flash_attention_kernel() -> _build.KernelSource:
    """The build record of ``csrc/flash_attention.cu`` (f32, FFMA)."""
    return _build.KernelSource("flash_attention",
                               _build.csrc("flash_attention.cu"))


def flash_attention_sm90_kernel() -> _build.KernelSource:
    """The build record of ``csrc/flash_attention_sm90.cu`` (bf16,
    ``wgmma`` fed by TMA)."""
    return _build.KernelSource("flash_attention_sm90",
                               _build.csrc("flash_attention_sm90.cu"))


def kernel_sources() -> list:
    """Both libraries the wrapper may launch."""
    return [flash_attention_kernel(), flash_attention_sm90_kernel()]


def sm90_plan(d: int) -> dict:
    """The bf16 kernel's tiles for head dim ``d``, as its launcher
    computes them: 128 query rows (two consumer warpgroups of 64), D
    padded to whole 64-column swizzle atoms, KV tiles of 128 rows in a
    three-stage K / V ring up to D = 128 and of 64 rows in two stages
    above, and the dynamic shared memory that takes (1 KB of alignment
    slack, Q, the ring, the mbarriers)."""
    dp = -(-d // 64) * 64
    bkv, stages = (128, 3) if dp <= 128 else (64, 2)
    smem = 1024 + SM90_BLOCK_Q * dp * 2 + stages * 2 * bkv * dp * 2 \
        + 8 * (1 + 3 * stages)
    return {"block_q": SM90_BLOCK_Q, "block_kv": bkv, "stages": stages,
            "padded_dim": dp, "smem_bytes": smem}


def ffma_plan(d: int) -> dict:
    """The f32 kernel's launch for head dim ``d``, as its launcher
    computes it (the twin of ``plan`` in ``csrc/flash_attention.cu``):
    128 threads of 8 query rows up to D = 128, 256 of 4 above; 64-query
    and 64-key tiles; shared memory for Q, one K and one V tile and P
    (no padding); and the blocks an SM's shared memory holds (the card's
    registers may allow fewer: :func:`ffma_occupancy`)."""
    threads, rows = (128, 8) if d <= 128 else (256, 4)
    smem = 4 * (FFMA_BLOCK_Q * d + 2 * FFMA_BLOCK_KV * d
                + FFMA_BLOCK_KV * FFMA_BLOCK_Q)
    fit = min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // threads)
    return {"threads": threads, "rows": rows, "block_q": FFMA_BLOCK_Q,
            "block_kv": FFMA_BLOCK_KV, "smem_bytes": smem,
            "blocks_per_sm": fit}


def c_ffma_plan(d: int) -> dict:
    """The plan the f32 library's ``lapis_flash_f32_plan`` computes, in
    :func:`ffma_plan`'s form (builds the library)."""
    fn = _build.load(flash_attention_kernel()).lapis_flash_f32_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(FFMA_PLAN_FIELDS))()
    _build.check(fn(d, ctypes.cast(out, ctypes.c_void_p)),
                 f"lapis_flash_f32_plan({d})")
    return dict(zip(FFMA_PLAN_FIELDS, out))


def ffma_occupancy(d: int) -> int:
    """Blocks of the f32 kernel for head dim ``d`` an SM holds at once,
    as the card's occupancy calculator gives them (needs the card)."""
    fn = _build.load(flash_attention_kernel()).lapis_flash_f32_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    _build.check(fn(d, ctypes.byref(out)), f"lapis_flash_f32_occupancy({d})")
    return out.value


def async_ready(t: torch.Tensor) -> bool:
    """Can the f32 kernel's 16-byte ``cp.async`` copies read this
    (B, H, S, D) operand in place?  The head dim contiguous, the base
    16-byte aligned and every (batch, head, position) stride a multiple
    of 4 elements."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and \
        all(s % 4 == 0 for s in _map_strides(t))


def tma_ready(t: torch.Tensor) -> bool:
    """Can a TMA tensor map read this (B, H, S, D) bf16 operand in place?
    The head dim must be contiguous, the base 16-byte aligned, and every
    other stride of an extent above 1 a positive multiple of 16 bytes."""
    if t.stride(3) != 1 or t.data_ptr() % 16:
        return False
    return all(n == 1 or (s > 0 and s * t.element_size() % 16 == 0)
               for n, s in zip(t.shape[:3], t.stride()[:3]))


def _map_strides(t: torch.Tensor) -> tuple:
    """(batch, head, position) strides for a tensor map; an extent of 1
    gets its contiguous stride, since torch leaves that stride free."""
    return tuple(t.stride(i) if t.shape[i] > 1 else math.prod(t.shape[i + 1:])
                 for i in range(3))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        if dtype == torch.bfloat16:
            fn = _build.load(flash_attention_sm90_kernel()) \
                .lapis_flash_attention_sm90
        else:
            fn = _build.load(flash_attention_kernel()) \
                .lapis_flash_attention_f32
        fn.argtypes = _ARGTYPES
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
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}; the kernels take float32 or bfloat16 "
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
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        # a fresh copy: an offset view may be contiguous and still
        # misaligned, and .contiguous() would hand it back as it is
        q, k, v = (t if tma_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        q, k, v = (t if async_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    fn = _launcher(q.dtype)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_long * 9)(*(s for t in (q, k, v)
                                    for s in _map_strides(t)))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Hq, Hkv, Sq, Skv, D, ctypes.cast(strides,
                                                        ctypes.c_void_p),
                    int(causal), -1 if window is None else int(window),
                    float(scale), float(logit_softcap or 0.0),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    if sm90:
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_ffma += 1
    return out


flash_attention.launches = 0        # both kernels
flash_attention.launches_sm90 = 0   # bf16: csrc/flash_attention_sm90.cu
flash_attention.launches_ffma = 0   # f32: csrc/flash_attention.cu
flash_attention.plain_calls = 0
