"""Python frontend — the repro analogue of torch-mlir / MPACT.

``trace(fn, *specs)`` runs ``fn`` on symbolic ``TracedValue``s and records
every ``repro_torch.core.ops`` call into a tensor-dialect ``Graph`` (the
linalg-on-tensors level of the paper).  Shapes/dtypes are inferred by
running each op's reference implementation on ``meta`` tensors, so the
tracer never materializes data.

IR types spell dtypes by name (``"float32"``, ``"bfloat16"``, ``"int32"``
…); :func:`torch_dtype` and :func:`dtype_name` are the one table between
those names and torch dtypes.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ir import Graph, MemorySpace, Op, TensorType, Value

_tls = threading.local()

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dtype) -> torch.dtype:
    """IR dtype name (or a numpy / torch dtype) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[dtype_name(dtype)]


def dtype_name(dtype) -> str:
    """A torch dtype, numpy dtype or name → the IR's dtype name."""
    if isinstance(dtype, torch.dtype):
        return _NAMES[dtype]
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return name


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype of a traced argument (the ShapeDtypeStruct role)."""

    shape: tuple
    dtype: str

    @classmethod
    def of(cls, x) -> "TensorSpec":
        """The spec of anything with ``.shape`` and ``.dtype`` (a
        tensor, an array, or a spec)."""
        return cls(tuple(int(d) for d in x.shape), dtype_name(x.dtype))


class TracedValue:
    """A symbolic tensor flowing through a trace."""

    __slots__ = ("value",)

    def __init__(self, value: Value):
        self.value = value

    @property
    def shape(self) -> tuple:
        return self.value.type.shape

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.value.type.dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"TracedValue({self.value!r}: {self.value.type})"

    # operator sugar → core.ops (lazy import to avoid the cycle)
    def _ops(self):
        from repro_torch.core import ops
        return ops

    def __add__(self, other):  return self._ops().add(self, other)
    def __radd__(self, other): return self._ops().add(other, self)
    def __sub__(self, other):  return self._ops().sub(self, other)
    def __rsub__(self, other): return self._ops().sub(other, self)
    def __mul__(self, other):  return self._ops().mul(self, other)
    def __rmul__(self, other): return self._ops().mul(other, self)
    def __truediv__(self, other):  return self._ops().div(self, other)
    def __rtruediv__(self, other): return self._ops().div(other, self)
    def __matmul__(self, other):   return self._ops().matmul(self, other)
    def __neg__(self):         return self._ops().neg(self)
    def __pow__(self, p):      return self._ops().power(self, p)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._ops().reshape(self, shape)

    def transpose(self, *perm):
        if len(perm) == 1 and isinstance(perm[0], (tuple, list)):
            perm = tuple(perm[0])
        return self._ops().transpose(self, perm or None)

    @property
    def T(self):
        return self.transpose()

    def astype(self, dtype):
        return self._ops().cast(self, dtype)

    def sum(self, axis=None, keepdims=False):
        return self._ops().reduce_sum(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._ops().reduce_max(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._ops().mean(self, axis=axis, keepdims=keepdims)


class TraceContext:
    def __init__(self, name: str):
        self.graph = Graph(name, inputs=[])
        self.const_cache: dict = {}


def current_trace() -> Optional[TraceContext]:
    return getattr(_tls, "trace", None)


def tracing() -> bool:
    return current_trace() is not None


def _set_trace(ctx: Optional[TraceContext]):
    _tls.trace = ctx


def lift_constant(x) -> TracedValue:
    """Emit a tensor.constant for a concrete array/tensor/scalar met during
    tracing (model weights captured by closure — the paper embeds these in
    the generated C++).  A tensor stays a tensor (on whatever device it
    lives); anything else becomes a numpy array."""
    ctx = current_trace()
    assert ctx is not None
    key = id(x) if isinstance(x, (np.ndarray, torch.Tensor)) else None
    if key is not None and key in ctx.const_cache:
        return ctx.const_cache[key]
    value = x if isinstance(x, torch.Tensor) else np.asarray(x)
    t = TensorType(tuple(value.shape), dtype_name(value.dtype))
    op = ctx.graph.add(Op("tensor.constant", [], [t], attrs={"value": value}))
    tv = TracedValue(op.results[0])
    if key is not None:
        ctx.const_cache[key] = tv
    return tv


def as_traced(x) -> TracedValue:
    if isinstance(x, TracedValue):
        return x
    return lift_constant(x)


def _meta(t: TensorType) -> torch.Tensor:
    return torch.empty(t.shape, dtype=torch_dtype(t.dtype), device="meta")


def emit(opname: str, inputs: Sequence, ref: Callable,
         attrs: Optional[dict] = None, n_results: int = 1) -> TracedValue:
    """Record one op; infer result types by running ``ref`` on meta
    tensors."""
    ctx = current_trace()
    assert ctx is not None, "emit() outside of a trace"
    traced = [as_traced(x) for x in inputs]
    out = ref(*[_meta(t.value.type) for t in traced])
    flat = list(out) if isinstance(out, (tuple, list)) else [out]
    result_types = [TensorType(tuple(o.shape), dtype_name(o.dtype))
                    for o in flat]
    op = ctx.graph.add(
        Op(opname, [t.value for t in traced], result_types, attrs=attrs))
    results = [TracedValue(r) for r in op.results]
    return results[0] if n_results == 1 else tuple(results)


def emit_op(opname: str, inputs: Sequence, result_types: Sequence,
            attrs: Optional[dict] = None):
    """Record one op with *explicit* result types — for ops whose
    semantics no meta-tensor run can infer (composite sparse values have
    no tensor form).  Returns one TracedValue or a tuple."""
    ctx = current_trace()
    assert ctx is not None, "emit_op() outside of a trace"
    traced = [as_traced(x) for x in inputs]
    op = ctx.graph.add(
        Op(opname, [t.value for t in traced], list(result_types),
           attrs=attrs))
    results = [TracedValue(r) for r in op.results]
    return results[0] if len(results) == 1 else tuple(results)


def trace(fn: Callable, *arg_specs, name: Optional[str] = None,
          encodings: Optional[Sequence] = None) -> Graph:
    """Trace ``fn`` over specs (anything with ``.shape``/``.dtype``) into
    a Graph; ``encodings[i]``, where given, puts a ``SparseEncoding`` on
    argument ``i``'s type."""
    ctx = TraceContext(name or getattr(fn, "__name__", "main"))
    args = []
    for i, spec in enumerate(arg_specs):
        enc = encodings[i] if encodings else None
        t = TensorType(tuple(spec.shape), dtype_name(spec.dtype),
                       MemorySpace.ANY, enc)
        v = Value(t, name=f"arg{i}")
        ctx.graph.inputs.append(v)
        args.append(TracedValue(v))
    prev = current_trace()
    _set_trace(ctx)
    try:
        out = fn(*args)
    finally:
        _set_trace(prev)
    outs = out if isinstance(out, (tuple, list)) else [out]
    ctx.graph.outputs = [as_traced(o).value for o in outs]
    return ctx.graph
