"""Per-op reference semantics: opname+attrs → plain torch callable.

Used by the emitter (the library lowering of any op that was not
intercepted by a library call or a hand kernel), by :func:`region_ref`
(the interpreter that gives a ``kokkos.fused`` region its executable
meaning), by the tracer (run on ``meta`` tensors for shape inference) and
by tests as the oracle.

The semantics are the reference package's (``repro.core.refs``), spelled
in torch.  Where the two frameworks differ, the reference wins:

* ``linalg.gelu`` is the tanh approximation;
* ``tensor.slice`` wraps negative starts once and clamps every start so
  the window fits, as ``jax.lax.dynamic_slice`` does;
* ``tensor.gather`` wraps negative indices once and fills indices still
  out of range (NaN for floats, the type's minimum for integers), as
  ``jnp.take`` does;
* softmax subtracts the row maximum before exponentiating;
* ``"SAME"`` padding of convolutions and pools puts the odd row and
  column at the end, as XLA does (torch's symmetric ``padding=`` gives
  the same output size and other values);
* matmul-like ops promote mixed operand types first (torch refuses them);
* integer sums keep the operand's integer type.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F


def _dims(axis, ndim: int) -> tuple:
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def matmul(a, b):
    return torch.matmul(*_promoted(a, b))


def dot(a, b):
    """``jnp.dot``: a product for scalars, ``matmul`` when ``b`` is a
    vector, otherwise a contraction of ``a``'s last axis with ``b``'s
    second-to-last."""
    a, b = _promoted(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def softmax(a, axis=-1):
    m = a.amax(dim=axis, keepdim=True)
    e = torch.exp(a - m)
    return e / e.sum(dim=axis, keepdim=True)


def reduce_sum(a, axis=None, keepdims=False):
    dtype = None if (a.is_floating_point() or a.is_complex()) else (
        torch.int32 if a.dtype == torch.bool else a.dtype)
    return torch.sum(a, dim=_dims(axis, a.ndim), keepdim=keepdims,
                     dtype=dtype)


def reduce_max(a, axis=None, keepdims=False):
    return torch.amax(a, dim=_dims(axis, a.ndim), keepdim=keepdims)


def mean(a, axis=None, keepdims=False):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return torch.mean(a, dim=_dims(axis, a.ndim), keepdim=keepdims)


def transpose(a, perm=None):
    perm = tuple(perm) if perm is not None else tuple(range(a.ndim))[::-1]
    return a.permute(*perm)


def dynamic_slice(a, starts, sizes):
    """``jax.lax.dynamic_slice``: a negative start counts from the end
    once, then every start is clamped so the window lies inside."""
    idx = []
    for s, z, d in zip(starts, sizes, a.shape):
        s = int(s)
        s = s + d if s < 0 else s
        s = min(max(s, 0), d - int(z))
        idx.append(slice(s, s + int(z)))
    return a[tuple(idx)]


def pad(a, pads, value=0.0):
    flat = [p for lo_hi in reversed(tuple(pads)) for p in lo_hi]
    return F.pad(a, flat, value=value)


def take(a, i, axis=0):
    """``jnp.take``: a negative index counts from the end once; indices
    still outside ``[0, n)`` read a fill value (NaN for floats, the
    type's minimum for integers) instead of raising."""
    axis = axis % a.ndim
    n = a.shape[axis]
    i = i.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    valid = (i >= 0) & (i < n)
    safe = torch.where(valid, i, torch.zeros_like(i))
    out = torch.index_select(a, axis, safe.reshape(-1))
    out = out.reshape(a.shape[:axis] + i.shape + a.shape[axis + 1:])
    mask = valid.reshape((1,) * axis + tuple(i.shape)
                         + (1,) * (a.ndim - axis - 1))
    fill = (float("nan") if a.is_floating_point()
            else torch.iinfo(a.dtype).min)
    return torch.where(mask, out, torch.full((), fill, dtype=a.dtype,
                                             device=a.device))


def same_pads(size: int, window: int, stride: int) -> tuple:
    """(lo, hi) padding of XLA's ``"SAME"``: the output has
    ceil(size / stride) positions and the odd row or column goes at the
    end (``F.conv2d(padding=k // 2)`` would put it at both ends)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x, window, stride, padding) -> tuple:
    """``F.pad``'s flat (w_lo, w_hi, h_lo, h_hi) for NCHW ``x``: from
    ``"SAME"``, ``"VALID"`` or explicit ((h_lo, h_hi), (w_lo, w_hi))."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding == "SAME":
        (h_lo, h_hi), (w_lo, w_hi) = (
            same_pads(x.shape[2 + i], window[i], stride[i]) for i in (0, 1))
    else:
        (h_lo, h_hi), (w_lo, w_hi) = (tuple(p) for p in padding)
    return (w_lo, w_hi, h_lo, h_hi)


def conv2d(x, w, stride=(1, 1), padding="SAME"):
    """``jax.lax.conv_general_dilated`` over NCHW / OIHW: pad as XLA
    does, then convolve unpadded."""
    stride = tuple(stride)
    pads = _spatial_pads(x, tuple(w.shape[2:]), stride, padding)
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def max_pool2d(x, window=(3, 3), stride=(2, 2), padding="SAME"):
    """``jax.lax.reduce_window(max)`` over H, W of NCHW, with -inf in the
    padding (the reduction's identity)."""
    window, stride = tuple(window), tuple(stride)
    pads = _spatial_pads(x, window, stride, padding)
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), window, stride)


def avg_pool_global(x):
    return torch.mean(x, dim=(2, 3))


def batch_norm(x, scale, bias, mean_, var, eps=1e-5):
    """Folded inference-mode batch norm over channel dim 1 of NCHW."""
    inv = scale * torch.rsqrt(var + eps)
    return x * inv[None, :, None, None] + (bias - mean_ * inv)[
        None, :, None, None]


_SIMPLE = {
    "linalg.add": torch.add,
    "linalg.sub": torch.sub,
    "linalg.mul": torch.mul,
    "linalg.div": torch.div,
    "linalg.maximum": torch.maximum,
    "linalg.relu": torch.relu,
    "linalg.gelu": partial(F.gelu, approximate="tanh"),
    "linalg.silu": F.silu,
    "linalg.sigmoid": torch.sigmoid,
    "linalg.tanh": torch.tanh,
    "linalg.exp": torch.exp,
    "linalg.neg": torch.neg,
    "linalg.sqrt": torch.sqrt,
    "linalg.rsqrt": torch.rsqrt,
    "linalg.matmul": matmul,
    "linalg.batch_matmul": matmul,
    "linalg.gemv": matmul,
    "linalg.dot": dot,
    "linalg.avg_pool_global": avg_pool_global,
    # kk.* library semantics
    "kk.gemm": matmul,
    "kk.gemv": matmul,
    "kk.batched_gemm": matmul,
}


def op_ref(opname: str, attrs: dict) -> Callable:
    """Return the plain torch callable implementing ``opname`` with
    ``attrs``."""
    if opname in _SIMPLE:
        return _SIMPLE[opname]
    if opname == "linalg.power":
        return lambda a: torch.pow(a, attrs["exponent"])
    if opname == "linalg.reduce_sum":
        return lambda a: reduce_sum(a, attrs.get("axis"),
                                    attrs.get("keepdims", False))
    if opname == "linalg.reduce_max":
        return lambda a: reduce_max(a, attrs.get("axis"),
                                    attrs.get("keepdims", False))
    if opname == "linalg.mean":
        return lambda a: mean(a, attrs.get("axis"),
                              attrs.get("keepdims", False))
    if opname == "kk.conv2d":
        return lambda x, w: conv2d(x, w, attrs["stride"], attrs["padding"])
    if opname == "linalg.batch_norm":
        return partial(batch_norm, eps=attrs.get("eps", 1e-5))
    if opname == "linalg.max_pool2d":
        return lambda x: max_pool2d(x, attrs["window"], attrs["stride"],
                                    attrs["padding"])
    if opname == "linalg.softmax":
        return lambda a: softmax(a, attrs.get("axis", -1))
    if opname == "tensor.reshape":
        return lambda a: torch.reshape(a, attrs["shape"])
    if opname == "tensor.transpose":
        return lambda a: transpose(a, attrs.get("perm"))
    if opname == "tensor.cast":
        from repro_torch.core.tracer import torch_dtype
        return lambda a: a.to(torch_dtype(attrs["dtype"]))
    if opname == "tensor.slice":
        return lambda a: dynamic_slice(a, attrs["starts"], attrs["sizes"])
    if opname == "tensor.concat":
        return lambda *a: torch.cat(a, dim=attrs.get("axis", 0))
    if opname == "tensor.broadcast":
        return lambda a: torch.broadcast_to(a, attrs["shape"])
    if opname == "tensor.pad":
        return lambda a: pad(a, attrs["pads"], attrs.get("value", 0.0))
    if opname == "tensor.gather":
        return lambda a, i: take(a, i, attrs.get("axis", 0))
    if opname in ("linalg.spmv_csr", "kk.spmv"):
        from repro_torch.kernels.spmv import spmv_reference
        return spmv_reference
    if opname in ("linalg.spmm_csr", "kk.spmm"):
        from repro_torch.kernels.spmv import spmm_reference
        return spmm_reference
    if opname in ("paged.gather", "kokkos.page_gather"):
        from repro_torch.core.ops import _page_gather_ref
        return _page_gather_ref(attrs["block_size"])
    if opname in ("paged.append", "kokkos.page_append"):
        from repro_torch.core.ops import _page_append_ref
        return _page_append_ref(attrs["block_size"])
    if opname in ("paged.copy", "paged.swap_in", "paged.swap_out",
                  "kokkos.page_copy"):
        from repro_torch.core.ops import _page_copy_ref
        return _page_copy_ref(attrs["block_size"])
    if opname in ("linalg.map",):
        return attrs["fn"]
    raise KeyError(f"no reference semantics for {opname}")


def region_ref(region) -> Callable:
    """Interpret a ``kokkos.fused`` region (an ``ir.Region`` of sub-op
    records) as one composed plain-torch callable: arguments bind to the
    block arguments, each sub-op runs its reference semantics over the
    SSA environment, and the region's yield is returned.  This is the
    executable meaning of the structured body — derived from IR data on
    demand, so the IR itself never carries a closure."""
    steps = [(op, op_ref(op.opname, op.attrs)) for op in region.ops]
    input_ids = [v.id for v in region.inputs]
    out_id = region.outputs[0].id

    def fn(*args):
        env = dict(zip(input_ids, args))
        for op, f in steps:
            env[op.results[0].id] = f(*[env[o.id] for o in op.operands])
        return env[out_id]
    return fn
