"""RWKV6 (Finch) WKV scan — the port of the reference's
``kernels/rwkv6.py`` (the prefill of the rwkv family).

:func:`rwkv6_scan` launches ``csrc/rwkv6.cu`` on CUDA tensors: a
chunked scan.  Time is cut into chunks of up to 64 steps (sub-chunks of
16 as anchors), each (batch, head, 64 state columns, chunk) a block:
from a zero state it computes its local y, its decay product and its
state contribution as matrix products (``mma.sync`` in 3xTF32, the
blocks of decayed r . k on FFMA) whose decay factors are products of w
ending at an anchor (never a quotient); the chunks hand their end
state along T through an f32 scratch in a fixed order, and each chunk's
y is corrected by the state it was handed.  :func:`wkv_plan` is the
launch plan (the twin of ``plan`` in the source, held to it on the
card).  Unlike the TPU kernel it takes an initial state and returns the
final one, so the serving prefill gets its decode state from the same
launch.  r, k, v and w are read through their (batch, time, head)
strides.  On CPU tensors the wrapper runs the plain version
(``ref.rwkv6_scan``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_K = 128          # state rows a block holds
MAX_V = 256          # state columns (64 a block)
SUB = 16             # steps a sub-chunk: the decay products' anchors
VS = 64              # state columns a block
THREADS = 256
MAX_NSUB = 4         # sub-chunks a chunk (64 steps)
SM_SMEM = 233_472    # shared memory of an SM (228 KB)
BLOCK_RESERVED = 1_024
PLAN_FIELDS = ("kmax", "nsub", "chunk", "chunks", "vslices", "tickets",
               "threads", "smem_bytes", "blocks_per_sm")
_FNS = {torch.float32: "lapis_rwkv6_f32", torch.bfloat16: "lapis_rwkv6_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up16(n: int) -> int:
    return _cdiv(n, 16) * 16


def smem_bytes(kmax: int, nsub: int, item: int) -> int:
    """A block's dynamic shared memory (``layout`` in the source): the raw
    r, k, w and v of its chunk (f32 in the f32 arrays' pitches, r^ and k^
    computed in place; bf16 packed, with r^, k^ and v in f32 apart), A
    (L x (L + 4)), the staged S_{c-1} (kmax x 72, over the dead raw inputs
    where they are large enough), and the per-k vectors.  f32 rows are
    padded (r^ by 4 floats, k^ / w by 8, v and S by 8) so that the lanes of
    an ``mma`` fragment load hit distinct banks."""
    L, pr, pk, lv = SUB * nsub, kmax + 4, kmax + 8, VS + 8
    pairs = max(nsub * (nsub - 1) // 2, 1)
    if item == 4:
        raw = _up16(L * pr * 4) + 2 * _up16(L * pk * 4) + _up16(L * lv * 4)
        ss_apart = L * pk < kmax * lv
    else:
        raw = 3 * _up16(L * kmax * item) + _up16(L * VS * item) + \
            _up16(L * pr * 4) + _up16(L * pk * 4) + _up16(L * lv * 4)
        ss_apart = 3 * L * kmax * item < kmax * lv * 4
    return raw + _up16(L * (L + 4) * 4) + \
        (_up16(kmax * lv * 4) if ss_apart else 0) + \
        _up16(kmax * 4) * 2 + 3 * _up16(nsub * kmax * 4) + \
        _up16(pairs * kmax * 4)


def wkv_plan(batch: int, t_len: int, n_heads: int, kd: int, vd: int,
             dtype: torch.dtype) -> dict:
    """The launch of a (batch, t_len, n_heads, kd / vd) scan in ``dtype``
    — the twin of ``plan`` in ``csrc/rwkv6.cu``.  ``kmax`` state rows a
    block (kd rounded up to 16, 32, 64 or 128), ``nsub`` sub-chunks of
    16 steps a chunk of ``chunk`` steps (4, fewer where T is short),
    ``chunks`` along T and ``vslices`` of 64 state columns: ``tickets``
    = batch × heads × vslices × chunks blocks of ``threads``, each with
    ``smem_bytes`` of shared memory, ``blocks_per_sm`` of which an SM's
    shared memory holds."""
    kmax = 16 if kd <= 16 else 32 if kd <= 32 else 64 if kd <= 64 else 128
    nsub = MAX_NSUB
    while nsub > 1 and SUB * nsub // 2 >= t_len:
        nsub //= 2
    chunks = _cdiv(t_len, SUB * nsub) if t_len > 0 else 1
    vslices = _cdiv(vd, VS)
    smem = smem_bytes(kmax, nsub, dtype.itemsize)
    return dict(kmax=kmax, nsub=nsub, chunk=SUB * nsub, chunks=chunks,
                vslices=vslices, tickets=batch * n_heads * vslices * chunks,
                threads=THREADS, smem_bytes=smem,
                blocks_per_sm=min(SM_SMEM // (smem + BLOCK_RESERVED),
                                  2048 // THREADS))


def c_plan(batch: int, t_len: int, n_heads: int, kd: int, vd: int,
           dtype: torch.dtype) -> dict:
    """The plan the library's exported ``lapis_rwkv6_plan`` computes, in
    :func:`wkv_plan`'s form (builds the library)."""
    fn = _build.load(rwkv6_kernel()).lapis_rwkv6_plan
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    _build.check(fn(batch, t_len, n_heads, kd, vd, dtype.itemsize, out),
                 f"lapis_rwkv6_plan({batch}, {t_len}, {n_heads}, {kd}, {vd})")
    return dict(zip(PLAN_FIELDS, out))


def rwkv6_kernel() -> _build.KernelSource:
    """The build record of ``csrc/rwkv6.cu``."""
    return _build.KernelSource("rwkv6", _build.csrc("rwkv6.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(rwkv6_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong,
                                               ctypes.c_void_p,
                                               ctypes.c_longlong] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
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
    plan = wkv_plan(B, T, H, K, V, r.dtype)
    units = B * H * plan["vslices"]
    # the chunks' end states and their flags (flags[0]: the ticket counter)
    carry = None if plan["chunks"] == 1 else torch.empty(
        units * (plan["chunks"] - 1) * plan["kmax"] * VS, dtype=torch.float32,
        device=v.device)
    flags = torch.zeros(1 + units * (plan["chunks"] - 1), dtype=torch.int32,
                        device=v.device)
    strides = (ctypes.c_long * 12)(*(s for t in (r, k, v, w)
                                     for s in t.stride()[:3]))
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), 0 if state is None else state.data_ptr(),
                    y.data_ptr(), s_out.data_ptr(),
                    0 if carry is None else carry.data_ptr(),
                    0 if carry is None else carry.numel(), flags.data_ptr(),
                    flags.numel(), B, H, T, K, V,
                    ctypes.cast(strides, ctypes.c_void_p),
                    torch.cuda.current_stream(v.device).cuda_stream),
                 "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0
rwkv6_scan.plain_calls = 0
