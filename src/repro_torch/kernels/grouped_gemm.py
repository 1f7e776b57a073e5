"""The MoE's expert products over the routed rows alone: two grouped
products over a compact buffer whose rows are sorted by expert, expert e
owning rows ``offsets[e]`` to ``offsets[e + 1]``.

* :func:`gate_up`: ``h[r] = act(x[r] · w_gate[e]) * (x[r] · w_up[e])``,
  the activation and the product in f32, h stored once;
* :func:`down`: ``y[r] = h[r] · w_down[e]``.

On the card (bf16 or f16) each launches ``csrc/grouped_gemm.cu``, which
reads the offsets on the card, so the caller never learns the loads: no
host synchronisation.  On CPU tensors each runs its plain version
(:func:`plain_gate_up`, :func:`plain_down`), a loop over the experts on
the offsets with f32 products, as the kernels accumulate.  A CUDA tensor
of another dtype raises; nothing falls back.  Rows past
``offsets[E]`` are left as they are.

This replaces no TPU kernel: the reference runs the expert FFNs as XLA
einsums over its padded capacity buffers
(``repro/models/moe.py::expert_ffn``), as the port's
``models/moe.py::expert_ffn`` still does where autograd records, a mesh
is active, or the card computes in f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

BM, BN, BK = 192, 128, 64      # csrc/grouped_gemm.cu: row block, an accumulator's columns, K step
MAX_EXPERTS = 1024
ACTS = {"silu": 0, "gelu": 1}
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grouped_gemm_kernel() -> _build.KernelSource:
    """The build record of ``csrc/grouped_gemm.cu``."""
    return _build.KernelSource("grouped_gemm", _build.csrc("grouped_gemm.cu"))


@functools.cache
def _lib():
    lib = _build.load(grouped_gemm_kernel())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lapis_grouped_gate_up.argtypes = [i32, i32] + [ptr] * 5 + [i32] * 5 + [ptr]
    lib.lapis_grouped_down.argtypes = [i32] + [ptr] * 5 + [i32] * 8 + [ptr]
    for fn in (lib.lapis_grouped_gate_up, lib.lapis_grouped_down):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def down_split(rows: int, n: int, k: int, sms: int) -> tuple:
    """(split, k_chunk) of :func:`down` over ``rows`` rows, ``n`` output
    columns and depth ``k``: where the row blocks the host can count on
    (rows / 192; an expert's partial block is on top) times the 256-column
    blocks give fewer than two items an SM, K is cut into ranges of whole
    K steps, at least 8 deep, until they do.  It reads only shapes."""
    items = _cdiv(rows, BM) * _cdiv(n, 2 * BN)
    split = 1
    if items < 2 * sms:
        split = max(1, min(_cdiv(2 * sms, items), k // (8 * BK)))
    k_chunk = _cdiv(_cdiv(k, split), BK) * BK
    return _cdiv(k, k_chunk), k_chunk


def _grid(rows: int, experts: int, n_tile_cols: int, split: int,
          sms: int) -> int:
    """One block an SM, or one an item where there are fewer: at most
    every row block (each expert adds one partial block) times the column
    blocks and K ranges."""
    return max(1, min(sms, (_cdiv(rows, BM) + experts) * n_tile_cols * split))


def _check(what, a, ws, offsets, k_axis) -> None:
    if a.ndim != 2 or any(w.ndim != 3 for w in ws) or \
            any(w.shape != ws[0].shape for w in ws) or \
            ws[0].shape[k_axis] != a.shape[1] or \
            tuple(offsets.shape) != (ws[0].shape[0] + 1,):
        raise ValueError(f"{what}: rows {tuple(a.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]}, offsets "
                         f"{tuple(offsets.shape)}")
    if a.dtype not in _DTYPES or any(w.dtype != a.dtype for w in ws) or \
            offsets.dtype != torch.int32:
        raise TypeError(f"{what}: rows {a.dtype}, weights "
                        f"{[w.dtype for w in ws]}, offsets {offsets.dtype}; "
                        "the kernel takes bfloat16 or float16 throughout "
                        "and int32 offsets")
    E, d0, d1 = ws[0].shape
    if E > MAX_EXPERTS or d0 % 8 or d1 % 8 or a.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {E} experts (at most {MAX_EXPERTS}), "
                         f"widths {d0} x {d1} (multiples of 8), "
                         f"{a.shape[0]} rows")
    if any(t.data_ptr() % 16 for t in (a, *ws)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def plain_gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  offsets: torch.Tensor, act: str) -> torch.Tensor:
    """:func:`gate_up` in plain torch, on any device: per expert two f32
    products over its rows, the activation and the product in f32, h in
    x's dtype; rows past ``offsets[E]`` are zero."""
    from repro_torch.models.layers import activation
    f = activation(act)
    h = torch.zeros((x.shape[0], w_gate.shape[2]), dtype=x.dtype,
                    device=x.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            xe = x[a:b].float()
            h[a:b] = (f(xe @ w_gate[e].float())
                      * (xe @ w_up[e].float())).to(x.dtype)
    return h


def plain_down(h: torch.Tensor, w_down: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """:func:`down` in plain torch, on any device: per expert one f32
    product over its rows, y in h's dtype; rows past ``offsets[E]`` are
    zero."""
    y = torch.zeros((h.shape[0], w_down.shape[2]), dtype=h.dtype,
                    device=h.device)
    bounds = offsets.tolist()
    for e in range(w_down.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            y[a:b] = (h[a:b].float() @ w_down[e].float()).to(h.dtype)
    return y


def gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            offsets: torch.Tensor, act: str) -> torch.Tensor:
    """x (R, M), w_gate / w_up (E, M, F), offsets (E + 1,) int32 →
    h (R, F) in x's dtype; ``act``: silu or gelu (the tanh form)."""
    if _build.on_cpu([x, w_gate, w_up, offsets], "grouped gate_up"):
        gate_up.plain_calls += 1
        return plain_gate_up(x, w_gate, w_up, offsets, act)
    if act not in ACTS:
        raise ValueError(f"grouped gate_up: activation {act!r}, not one of "
                         f"{sorted(ACTS)}")
    x, w_gate, w_up = x.contiguous(), w_gate.contiguous(), w_up.contiguous()
    _check("grouped gate_up", x, (w_gate, w_up), offsets, 1)
    (R, M), (E, F) = x.shape, (w_gate.shape[0], w_gate.shape[2])
    h = torch.empty((R, F), dtype=x.dtype, device=x.device)
    if R == 0:
        return h
    sms = _sms(x.device.index if x.device.index is not None
               else torch.cuda.current_device())
    _build.check(_lib().lapis_grouped_gate_up(
        _DTYPES[x.dtype], ACTS[act], x.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), offsets.contiguous().data_ptr(), h.data_ptr(),
        R, E, M, F, _grid(R, E, _cdiv(F, BN), 1, sms),
        torch.cuda.current_stream(x.device).cuda_stream), "grouped gate_up")
    gate_up.launches += 1
    return h


def down(h: torch.Tensor, w_down: torch.Tensor,
         offsets: torch.Tensor) -> torch.Tensor:
    """h (R, F), w_down (E, F, M), offsets (E + 1,) int32 → y (R, M) in
    h's dtype."""
    if _build.on_cpu([h, w_down, offsets], "grouped down"):
        down.plain_calls += 1
        return plain_down(h, w_down, offsets)
    h, w_down = h.contiguous(), w_down.contiguous()
    _check("grouped down", h, (w_down,), offsets, 1)
    (R, F), (E, M) = h.shape, (w_down.shape[0], w_down.shape[2])
    y = torch.empty((R, M), dtype=h.dtype, device=h.device)
    if R == 0:
        return y
    sms = _sms(h.device.index if h.device.index is not None
               else torch.cuda.current_device())
    split, k_chunk = down_split(R, M, F, sms)
    ws = None
    if split > 1:     # each K range's f32 partial products
        ws = torch.empty((split, R, M), dtype=torch.float32, device=h.device)
    _build.check(_lib().lapis_grouped_down(
        _DTYPES[h.dtype], h.data_ptr(), w_down.data_ptr(),
        offsets.contiguous().data_ptr(), y.data_ptr(),
        0 if ws is None else ws.data_ptr(), R, E, F, M, split, k_chunk,
        _grid(R, E, _cdiv(M, 2 * BN), split, sms),
        max(1, min(4 * sms, _cdiv(R * M // 4, 256))),
        torch.cuda.current_stream(h.device).cuda_stream), "grouped down")
    down.launches += 1
    return y


gate_up.launches = 0
gate_up.plain_calls = 0
down.launches = 0
down.plain_calls = 0
