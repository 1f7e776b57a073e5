"""The tensor-dialect op surface — repro's linalg-on-tensors builders
(the dense part: elementwise, reductions, softmax, shape ops, constants
and the matmul family).

Every function here is dual-mode:

* **tracing** (inside ``core.tracer.trace``) — records a ``linalg.*`` /
  ``tensor.*`` op into the Graph, with result types inferred from the
  plain torch reference run on meta tensors.
* **eager** — executes the reference directly on tensors (for
  ``kk.*``-backed hot ops, via the registry so the library-vs-kernel
  decision of ``linalg-to-kokkoskernels`` applies even outside the
  pipeline).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import refs, tracer
from repro_torch.core.tracer import emit, tracing


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _unary(opname: str, ref):
    def fn(x):
        if tracing():
            return emit(opname, [x], ref)
        return ref(x)
    fn.__name__ = opname.split(".", 1)[1]
    return fn


def _binary(opname: str, ref):
    def fn(a, b):
        if tracing():
            return emit(opname, [a, b], ref)
        return ref(a, b)
    fn.__name__ = opname.split(".", 1)[1]
    return fn


def _ref(opname: str):
    return refs.op_ref(opname, {})


# ---------------------------------------------------------------------------
# elementwise (linalg.*)
# ---------------------------------------------------------------------------
add = _binary("linalg.add", _ref("linalg.add"))
sub = _binary("linalg.sub", _ref("linalg.sub"))
mul = _binary("linalg.mul", _ref("linalg.mul"))
div = _binary("linalg.div", _ref("linalg.div"))
maximum = _binary("linalg.maximum", _ref("linalg.maximum"))

relu = _unary("linalg.relu", _ref("linalg.relu"))
gelu = _unary("linalg.gelu", _ref("linalg.gelu"))
silu = _unary("linalg.silu", _ref("linalg.silu"))
sigmoid = _unary("linalg.sigmoid", _ref("linalg.sigmoid"))
tanh = _unary("linalg.tanh", _ref("linalg.tanh"))
exp = _unary("linalg.exp", _ref("linalg.exp"))
neg = _unary("linalg.neg", _ref("linalg.neg"))
sqrt = _unary("linalg.sqrt", _ref("linalg.sqrt"))
rsqrt = _unary("linalg.rsqrt", _ref("linalg.rsqrt"))


def power(x, p):
    attrs = {"exponent": p}
    ref = refs.op_ref("linalg.power", attrs)
    if tracing():
        return emit("linalg.power", [x], ref, attrs=attrs)
    return ref(x)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduction(opname: str):
    def fn(x, axis=None, keepdims=False):
        attrs = {"axis": axis, "keepdims": keepdims}
        ref = refs.op_ref(opname, attrs)
        if tracing():
            return emit(opname, [x], ref, attrs=attrs)
        return ref(x)
    fn.__name__ = opname.split(".", 1)[1]
    return fn


reduce_sum = _reduction("linalg.reduce_sum")
reduce_max = _reduction("linalg.reduce_max")
mean = _reduction("linalg.mean")


def softmax(x, axis=-1):
    ref = lambda a: refs.softmax(a, axis)
    if tracing():
        return emit("linalg.softmax", [x], ref, attrs={"axis": axis})
    return ref(x)


# ---------------------------------------------------------------------------
# shape ops (tensor.*)
# ---------------------------------------------------------------------------

def _shape_op(opname: str, x, attrs: dict):
    ref = refs.op_ref(opname, attrs)
    if tracing():
        return emit(opname, [x], ref, attrs=attrs)
    return ref(x)


def reshape(x, shape):
    return _shape_op("tensor.reshape", x,
                     {"shape": tuple(int(s) for s in shape)})


def transpose(x, perm=None):
    return _shape_op("tensor.transpose", x, {"perm": perm})


def cast(x, dtype):
    return _shape_op("tensor.cast", x, {"dtype": tracer.dtype_name(dtype)})


def slice_(x, starts, sizes):
    return _shape_op("tensor.slice", x,
                     {"starts": tuple(starts), "sizes": tuple(sizes)})


def concat(xs, axis=0):
    ref = lambda *a: torch.cat(a, dim=axis)
    if tracing():
        return emit("tensor.concat", list(xs), ref, attrs={"axis": axis})
    return ref(*xs)


def broadcast_to(x, shape):
    return _shape_op("tensor.broadcast", x, {"shape": tuple(shape)})


def pad(x, pads, value=0.0):
    """pads: [(lo, hi), ...] per dim."""
    pads = tuple((int(l), int(h)) for l, h in pads)
    return _shape_op("tensor.pad", x, {"pads": pads, "value": value})


def gather(x, idx, axis=0):
    ref = lambda a, i: refs.take(a, i, axis)
    if tracing():
        return emit("tensor.gather", [x, idx], ref, attrs={"axis": axis})
    return ref(x, idx)


def constant(value):
    if tracing():
        return tracer.lift_constant(value)
    return torch.as_tensor(value)


# ---------------------------------------------------------------------------
# linear algebra (linalg.* — lowered to kk.* by linalg-to-kokkoskernels)
# ---------------------------------------------------------------------------

def _registry_call(kk_opname: str, *args, **kwargs):
    from repro_torch.core import registry
    fn = registry.dispatch(kk_opname)
    return fn(*args, **kwargs)


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def matmul(a, b):
    """2D×2D → linalg.matmul; (≥3D)×(≥2D) batched → linalg.batch_matmul."""
    a_nd, b_nd = _ndim(a), _ndim(b)
    if a_nd == 2 and b_nd == 2:
        if tracing():
            return emit("linalg.matmul", [a, b], refs.matmul)
        return _registry_call("kk.gemm", a, b)
    if a_nd == 2 and b_nd == 1:
        return gemv(a, b)
    if tracing():
        return emit("linalg.batch_matmul", [a, b], refs.matmul)
    return _registry_call("kk.batched_gemm", a, b)


def gemv(a, x):
    if tracing():
        return emit("linalg.gemv", [a, x], refs.matmul)
    return _registry_call("kk.gemv", a, x)


def dot(a, b):
    if tracing():
        return emit("linalg.dot", [a, b], refs.dot)
    return refs.dot(a, b)
