"""The Kokkos emitter, adapted (paper §4.4): the executable and source paths.

``build_callable`` turns a lowered graph into a torch callable (the
KokkosBackend / RefBackend-replacement path of the paper's §5 pipeline);
``emit_python_source`` serializes it as a freestanding torch module with
the weights embedded.
``kk.*`` ops dispatch through the registry (library vs hand kernel);
mapped ``kokkos.range_parallel`` / ``kokkos.team_parallel`` nests become
launches of the generated CUDA kernels built from the map_parallelism
attrs (collapsed nests on library backends run as one eager torch call,
and a backend's op-executor hook may claim them outright);
``kokkos.sync`` drives the lazy DualView runtime.

PyTorch runs eagerly, so there is no jit step: the callable walks the
bound executors in SSA order on every call.

Like the paper's emitter we walk the SSA graph in order and bind each
result to its producer's output.
"""
from __future__ import annotations

import base64
import io
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import refs
from repro_torch.core.dualview import DualView
from repro_torch.core.ir import Graph, Op
from repro_torch.core.irwalk import ValueNamer, bind_region_args, constant_label
from repro_torch.core.options import CompileOptions, current_options


# ---------------------------------------------------------------------------
# executable path
# ---------------------------------------------------------------------------

def _parallel_callable(op: Op, options: CompileOptions) -> Callable:
    """Materialize a mapped kokkos.*_parallel nest as a kernel launch.

    A nest lowered from a ``kokkos.fused`` region runs the whole multi-op
    body as ONE generated kernel — intermediates stay in registers
    (``generic.block_map_region``).  An unfused map nest carries only a
    torch closure in ``attrs["fn"]``, which no kernel can be made from,
    so its kernel is generated from ``attrs["src"]`` and the op's attrs,
    as a one-op region.  A ``kind='reduce'`` nest is a last-axis softmax
    and runs the fixed row-softmax kernel."""
    from repro_torch.kernels import generic
    kind = op.attrs["kind"]
    block = op.attrs["tiling"]["block"]
    out_shape = op.results[0].type.shape
    out_dtype = op.results[0].type.dtype
    if kind == "map":
        region = op.regions[0] if op.regions else generic.one_op_region(op)
        return lambda *a: generic.block_map_region(
            region, a, out_shape, out_dtype, block=block)
    if kind == "reduce" and op.attrs.get("src") == "linalg.softmax":
        axis = op.attrs.get("axis", -1)
        return lambda x: generic.row_softmax(x, axis=axis, block=block)
    raise NotImplementedError(f"no kernel for a {kind!r} nest of "
                              f"{op.attrs.get('src')}")


def _op_callable(op: Op, options: CompileOptions) -> Optional[Callable]:
    from repro_torch.core import registry
    # a backend may claim any op outright (e.g. the `loops` reference
    # backend interprets kokkos.*_parallel nests in eager torch)
    backend = options.backend()
    if backend.op_executor is not None:
        ex = backend.op_executor(op, options)
        if ex is not None:
            return ex
    if op.opname == "sparse.pack":
        # assemble the composite sparse value the encoding describes
        from repro_torch.kernels.spmv import CsrMatrix
        n_rows, n_cols = op.results[0].type.shape
        return lambda ip, ind, val: CsrMatrix(ip, ind, val, n_rows, n_cols)
    if op.opname == "sparse.convert":
        from repro_torch.kernels.spmv import as_ell
        mx = op.attrs.get("max_nnz_row")
        return lambda a, _mx=mx: as_ell(a, max_nnz_row=_mx)
    if op.opname == "kokkos.fused":
        # an unlowered fused region (e.g. mixed operand shapes kept it at
        # tensor level): interpret the structured body
        return refs.region_ref(op.regions[0])
    if op.opname.startswith("kk."):
        fn = registry.dispatch(op.opname, options)
        kwargs = _op_kwargs(op)
        if op.attrs.get("tiling"):
            kwargs["tiling"] = op.attrs["tiling"]
        return lambda *a, _fn=fn, _kw=kwargs: _fn(*a, **_kw)
    if op.opname in ("kokkos.page_gather", "kokkos.page_append",
                     "kokkos.page_copy"):
        # paged-KV cache plumbing dispatches through the registry like
        # kk.* library calls; the nest/tiling attrs describe the mapped
        # loop structure the backend implementation realizes
        fn = registry.dispatch(op.opname, options)
        bs = int(op.attrs["block_size"])
        return lambda *a, _fn=fn, _bs=bs: _fn(*a, block_size=_bs)
    if op.opname in ("kokkos.range_parallel", "kokkos.team_parallel"):
        if op.attrs.get("collapse"):
            # library mapping: the whole nest is one eager torch call
            return op.attrs["fn"]
        return _parallel_callable(op, options)
    return None


def _op_kwargs(op: Op) -> dict:
    """Forward data-independent attrs that implementations accept."""
    if op.opname in ("kk.spmv", "kk.spmm"):
        return {"max_nnz_row": op.attrs.get("max_nnz_row")}
    if op.opname == "kk.conv2d":
        return {"stride": tuple(op.attrs["stride"]),
                "padding": op.attrs["padding"]}
    return {}


def _as_input(x, device: str) -> torch.Tensor:
    """Graph inputs arrive as tensors on the module's device or as host
    arrays, which are copied there.  A tensor on another device is an
    error, never a silent transfer."""
    if isinstance(x, torch.Tensor):
        if x.device.type != torch.device(device).type:
            raise ValueError(f"input on {x.device}, module compiled for "
                             f"{device}")
        return x
    from repro_torch.convert import numpy_to_torch
    return numpy_to_torch(np.asarray(x)).to(device)


def build_callable(graph: Graph,
                   options: Optional[CompileOptions] = None) -> Callable:
    """Walk the lowered graph once, binding each op to an executor; return
    ``fn(*inputs) -> outputs``."""
    options = options or current_options()
    device = options.resolve_device()

    # constants → DualViews (host-resident until first device use; the
    # kokkos.sync inserted by memory_space_management triggers the lazy
    # h2d copy).  A weight that already lives on the device is adopted as
    # the device side, with no host copy.
    const_views: dict = {}
    executors = []  # (op, callable|None)
    for op in graph.ops:
        if op.opname == "tensor.constant":
            value = op.attrs["value"]
            name = f"const_{op.results[0].id}"
            if isinstance(value, torch.Tensor) and \
                    value.device.type == torch.device(device).type:
                dv = DualView.from_device(value, name=name)
            else:
                dv = DualView.from_host(value, name=name, device=device)
            const_views[op.results[0].id] = dv
            executors.append((op, None))
        elif op.opname in ("kokkos.sync", "kokkos.modify"):
            executors.append((op, None))
        else:
            ex = _op_callable(op, options)
            if ex is None:
                ex = refs.op_ref(op.opname, op.attrs)
            executors.append((op, ex))

    input_ids = [v.id for v in graph.inputs]
    output_ids = [v.id for v in graph.outputs]

    def run(*args):
        if len(args) != len(input_ids):
            raise TypeError(f"{graph.name} expects {len(input_ids)} args, "
                            f"got {len(args)}")
        env = {i: _as_input(a, device) for i, a in zip(input_ids, args)}
        for op, ex in executors:
            if op.opname == "tensor.constant":
                # value lands in env at sync time (lazy); put view for now
                env[op.results[0].id] = const_views[op.results[0].id]
            elif op.opname == "kokkos.sync":
                v = env[op.operands[0].id]
                if op.attrs.get("space") == "host_roundtrip":
                    # eager baseline-MLIR mode: force d2h + h2d around
                    # every kernel
                    if not isinstance(v, DualView):
                        from repro_torch.core.dualview import TRANSFERS
                        host = v.to("cpu")
                        TRANSFERS["d2h"] += 1
                        env[op.operands[0].id] = host.to(device)
                        TRANSFERS["h2d"] += 1
                elif isinstance(v, DualView):
                    env[op.operands[0].id] = v.device()  # lazy h2d
            elif op.opname == "kokkos.modify":
                v = env[op.operands[0].id]
                if isinstance(v, DualView):
                    v.modify_device()
            else:
                vals = []
                for o in op.operands:
                    x = env[o.id]
                    vals.append(x.device() if isinstance(x, DualView) else x)
                out = ex(*vals)
                if len(op.results) == 1:
                    env[op.results[0].id] = out
                else:
                    for r, v in zip(op.results, out):
                        env[r.id] = v
        outs = []
        for oid in output_ids:
            v = env[oid]
            outs.append(v.device() if isinstance(v, DualView) else v)
        return outs[0] if len(outs) == 1 else tuple(outs)

    # kernel-launch count: one dispatch per bound executor (constants and
    # sync/modify bookkeeping are not launches).  A fused chain of N
    # elementwise ops contributes ONE.
    run.const_views = const_views
    run.graph = graph
    run.launch_count = sum(1 for _, ex in executors if ex is not None)
    return run


# ---------------------------------------------------------------------------
# source path (freestanding .py with embedded weights)
# ---------------------------------------------------------------------------

# Library semantics, as the reference's emitted module calls jnp and no
# Pallas kernel: every op is a torch call (or a prelude helper copying
# the port's refs where torch's default differs from the reference's).
_SRC_OPS = {
    "linalg.add": "torch.add({0}, {1})",
    "linalg.sub": "torch.sub({0}, {1})",
    "linalg.mul": "torch.mul({0}, {1})",
    "linalg.div": "torch.div({0}, {1})",
    "linalg.maximum": "torch.maximum({0}, {1})",
    "linalg.relu": "torch.relu({0})",
    "linalg.gelu": "F.gelu({0}, approximate='tanh')",
    "linalg.silu": "F.silu({0})",
    "linalg.sigmoid": "torch.sigmoid({0})",
    "linalg.tanh": "torch.tanh({0})",
    "linalg.exp": "torch.exp({0})",
    "linalg.neg": "torch.neg({0})",
    "linalg.sqrt": "torch.sqrt({0})",
    "linalg.rsqrt": "torch.rsqrt({0})",
    "linalg.matmul": "_matmul({0}, {1})",
    "linalg.batch_matmul": "_matmul({0}, {1})",
    "linalg.gemv": "_matmul({0}, {1})",
    "linalg.dot": "_dot({0}, {1})",
    "kk.gemm": "_matmul({0}, {1})",
    "kk.batched_gemm": "_matmul({0}, {1})",
    "kk.gemv": "_matmul({0}, {1})",
    "linalg.avg_pool_global": "torch.mean({0}, dim=(2, 3))",
}


def _dtype_src(dtype) -> str:
    """An IR dtype (name, numpy or torch dtype) spelled as ``torch.<name>``."""
    from repro_torch.core.tracer import dtype_name
    return f"torch.{dtype_name(dtype)}"


def _src_line(op: Op, names: dict) -> str:
    a = [names[o.id] for o in op.operands]
    res = names[op.results[0].id]
    tmpl = _SRC_OPS.get(op.opname)
    if tmpl is not None:
        return f"{res} = {tmpl.format(*a)}"
    at = op.attrs
    if op.opname == "linalg.power":
        e = at["exponent"]
        e = float(e) if isinstance(e, np.ndarray) else e
        return f"{res} = torch.pow({a[0]}, {e!r})"
    if op.opname == "linalg.reduce_sum":
        return (f"{res} = _reduce_sum({a[0]}, {at.get('axis')!r}, "
                f"{at.get('keepdims', False)!r})")
    if op.opname == "linalg.reduce_max":
        return (f"{res} = _reduce_max({a[0]}, {at.get('axis')!r}, "
                f"{at.get('keepdims', False)!r})")
    if op.opname == "linalg.mean":
        return (f"{res} = _mean({a[0]}, {at.get('axis')!r}, "
                f"{at.get('keepdims', False)!r})")
    if op.opname == "linalg.softmax":
        return f"{res} = _softmax({a[0]}, {at.get('axis', -1)!r})"
    if op.opname == "tensor.reshape":
        return f"{res} = torch.reshape({a[0]}, {tuple(at['shape'])!r})"
    if op.opname == "tensor.transpose":
        perm = at.get("perm")
        perm = tuple(perm) if perm is not None else None
        return f"{res} = _transpose({a[0]}, {perm!r})"
    if op.opname == "tensor.cast":
        return f"{res} = {a[0]}.to({_dtype_src(at['dtype'])})"
    if op.opname == "tensor.slice":
        return (f"{res} = _dynamic_slice({a[0]}, {tuple(at['starts'])!r}, "
                f"{tuple(at['sizes'])!r})")
    if op.opname == "tensor.concat":
        return (f"{res} = torch.cat(({', '.join(a)},), "
                f"dim={at.get('axis', 0)!r})")
    if op.opname == "tensor.broadcast":
        return (f"{res} = torch.broadcast_to({a[0]}, "
                f"{tuple(at['shape'])!r})")
    if op.opname == "tensor.pad":
        pads = tuple(tuple(p) for p in at["pads"])
        return (f"{res} = _pad({a[0]}, {pads!r}, "
                f"{float(at.get('value', 0.0))!r})")
    if op.opname == "tensor.gather":
        return f"{res} = _take({a[0]}, {a[1]}, {at.get('axis', 0)!r})"
    if op.opname == "sparse.pack":
        n_rows, n_cols = op.results[0].type.shape
        return (f"{res} = _sparse_pack({a[0]}, {a[1]}, {a[2]}, "
                f"{n_rows}, {n_cols})")
    if op.opname == "sparse.convert":
        return (f"{res} = _sparse_convert({a[0]}, "
                f"{at.get('max_nnz_row')!r})")
    if op.opname in ("linalg.spmv_csr", "kk.spmv"):
        return f"{res} = _spmv({a[0]}, {a[1]})"
    if op.opname in ("linalg.spmm_csr", "kk.spmm"):
        return f"{res} = _spmm({a[0]}, {a[1]})"
    if op.opname == "kk.conv2d":
        return (f"{res} = _conv2d({a[0]}, {a[1]}, "
                f"{tuple(at['stride'])!r}, {at['padding']!r})")
    if op.opname == "linalg.batch_norm":
        return (f"{res} = _batch_norm({', '.join(a)}, "
                f"eps={at.get('eps', 1e-5)!r})")
    if op.opname in ("paged.gather", "kokkos.page_gather"):
        return f"{res} = _page_gather({a[0]}, {a[1]}, {a[2]})"
    if op.opname in ("paged.append", "kokkos.page_append"):
        return (f"{res} = _page_append({a[0]}, {a[1]}, {a[2]}, {a[3]}, "
                f"{int(at['block_size'])!r})")
    if op.opname in ("paged.copy", "paged.swap_in", "paged.swap_out",
                     "kokkos.page_copy"):
        return f"{res} = _page_copy({a[0]}, {a[1]}, {a[2]}, {a[3]})"
    if op.opname == "linalg.max_pool2d":
        return (f"{res} = _max_pool2d({a[0]}, {tuple(at['window'])!r}, "
                f"{tuple(at['stride'])!r}, {at['padding']!r})")
    raise NotImplementedError(f"source emission for {op.opname}")


def _fused_region_lines(op: Op, names: ValueNamer) -> list:
    """Serialize a ``kokkos.fused`` region (or a parallel nest lowered
    from one) by re-emitting its recorded sub-op chain: block args bind
    to the outer operands' names (:func:`~repro_torch.core.irwalk.
    bind_region_args` — the same routing the C++ path replays), each
    sub-op becomes an ordinary source line, and the op's result takes
    the yielded value's name.  The body is IR data, so the source path
    is total on fused graphs."""
    region = op.regions[0]
    local = bind_region_args(op, names)
    lines = ["# kokkos.fused: " +
             " -> ".join(s.opname for s in region.ops)]
    for sub in region.ops:
        for r in sub.results:
            local[r.id] = names.fresh()
        lines.append(_src_line(sub, local))
    for r, out in zip(op.results, region.outputs):
        names[r.id] = local[out.id]
    return lines


# The emitted module's fixed head.  Each helper is a copy of its
# counterpart in ``repro_torch.core.refs`` (or of the plain sparse and
# paged versions), kept in step by tests/test_torch_emitter.py: the
# module is freestanding and cannot import them.
_PRELUDE = '''\
"""Auto-generated by the LAPIS-style emitter (lapis-translate, Python
form).  Freestanding: depends only on torch + numpy.  Model weights are
embedded below as a base64 npz blob (the paper embeds them as C++
constant arrays); bf16 / f16 weights travel as integers of their width,
their dtype named in _WEIGHT_DTYPES.  Call lapis_initialize(device=None)
to load them (on _DEVICE, the compile's device, unless another is
named); the entry function calls it too."""
import base64
import io

import numpy as np
import torch
import torch.nn.functional as F


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _matmul(a, b):
    return torch.matmul(*_promoted(a, b))


def _dot(a, b):
    """jnp.dot: a product for scalars, matmul when b is a vector, else a
    contraction of a's last axis with b's second-to-last."""
    a, b = _promoted(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def _softmax(a, axis=-1):
    m = a.amax(dim=axis, keepdim=True)
    e = torch.exp(a - m)
    return e / e.sum(dim=axis, keepdim=True)


def _reduce_sum(a, axis=None, keepdims=False):
    dtype = None if (a.is_floating_point() or a.is_complex()) else (
        torch.int32 if a.dtype == torch.bool else a.dtype)
    return torch.sum(a, dim=_dims(axis, a.ndim), keepdim=keepdims,
                     dtype=dtype)


def _reduce_max(a, axis=None, keepdims=False):
    return torch.amax(a, dim=_dims(axis, a.ndim), keepdim=keepdims)


def _mean(a, axis=None, keepdims=False):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return torch.mean(a, dim=_dims(axis, a.ndim), keepdim=keepdims)


def _transpose(a, perm=None):
    perm = tuple(perm) if perm is not None else tuple(range(a.ndim))[::-1]
    return a.permute(*perm)


def _dynamic_slice(a, starts, sizes):
    """XLA's dynamic slice: a negative start counts from the end once,
    then every start is clamped so the window lies inside."""
    idx = []
    for s, z, d in zip(starts, sizes, a.shape):
        s = int(s)
        s = s + d if s < 0 else s
        s = min(max(s, 0), d - int(z))
        idx.append(slice(s, s + int(z)))
    return a[tuple(idx)]


def _pad(a, pads, value=0.0):
    """jnp.pad's per-axis (lo, hi) pairs as F.pad's reversed flat list."""
    flat = [p for lo_hi in reversed(tuple(pads)) for p in lo_hi]
    return F.pad(a, flat, value=value)


def _take(a, i, axis=0):
    """jnp.take: a negative index counts from the end once; indices still
    outside [0, n) read a fill value (NaN for floats, the type's minimum
    for integers) instead of raising."""
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


def _same_pads(size, window, stride):
    """(lo, hi) padding of XLA's "SAME": the odd row or column goes at the
    end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x, window, stride, padding):
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding == "SAME":
        (h_lo, h_hi), (w_lo, w_hi) = (
            _same_pads(x.shape[2 + i], window[i], stride[i]) for i in (0, 1))
    else:
        (h_lo, h_hi), (w_lo, w_hi) = (tuple(p) for p in padding)
    return (w_lo, w_hi, h_lo, h_hi)


def _conv2d(x, w, stride=(1, 1), padding="SAME"):
    """NCHW / OIHW convolution, padded as XLA pads, then unpadded."""
    stride = tuple(stride)
    pads = _spatial_pads(x, tuple(w.shape[2:]), stride, padding)
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def _max_pool2d(x, window=(3, 3), stride=(2, 2), padding="SAME"):
    """reduce_window(max) over H, W of NCHW, -inf in the padding."""
    window, stride = tuple(window), tuple(stride)
    pads = _spatial_pads(x, window, stride, padding)
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), window, stride)


def _batch_norm(x, scale, bias, mean_, var, eps=1e-5):
    inv = scale * torch.rsqrt(var + eps)
    return x * inv[None, :, None, None] + (bias - mean_ * inv)[
        None, :, None, None]


def _sparse_pack(indptr, indices, values, n_rows, n_cols):
    """Composite CSR value (a tagged tuple)."""
    return ("csr", indptr, indices, values, n_rows, n_cols)


def _sparse_convert(a, max_nnz_row, pad_to=8):
    """CSR -> padded-ELL layout change (sparse.convert); the storage
    width is max_nnz_row rounded up to pad_to, at least pad_to."""
    _, ip, ind, val, n_rows, n_cols = a
    width = max(-(-max(max_nnz_row or 1, 1) // pad_to) * pad_to, pad_to)
    dev = val.device
    row_len = ip[1:] - ip[:-1]
    offs = torch.arange(width, device=dev)[None, :]
    valid = offs < row_len[:, None]
    nnz = val.shape[0]
    if n_rows == 0 or nnz == 0:
        return ("ell", torch.zeros((n_rows, width), dtype=val.dtype,
                                   device=dev),
                torch.zeros((n_rows, width), dtype=torch.int32, device=dev),
                valid, n_rows, n_cols)
    idx = (ip[:-1, None].to(torch.int64) + offs).clamp(0, nnz - 1)
    vals = torch.where(valid, val[idx], 0).to(val.dtype)
    cols = torch.where(valid, ind[idx], 0).to(torch.int32)
    return ("ell", vals, cols, valid, n_rows, n_cols)


def _csr_row_ids(indptr, nnz, n_rows):
    lengths = (indptr[1:] - indptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), lengths,
        output_size=nnz)


def _spmv(a, x):
    if a[0] == "ell":
        _, vals, cols, valid, n_rows, _ = a
        x_g = torch.where(valid, x[cols.to(torch.int64)], 0.0)
        return torch.sum(vals * x_g, dim=1).to(x.dtype)
    _, ip, ind, val, n_rows, _ = a
    dtype = torch.promote_types(val.dtype, x.dtype)
    if val.shape[0] == 0:
        return torch.zeros((n_rows,), dtype=dtype, device=x.device)
    rows = _csr_row_ids(ip, val.shape[0], n_rows)
    prod = val.to(dtype) * x.to(dtype)[ind.to(torch.int64)]
    return torch.zeros((n_rows,), dtype=dtype,
                       device=x.device).index_add_(0, rows, prod)


def _spmm(a, b):
    if a[0] == "ell":
        _, vals, cols, valid, n_rows, _ = a
        b_g = torch.where(valid[:, :, None], b[cols.to(torch.int64)], 0.0)
        return torch.sum(vals[:, :, None] * b_g, dim=1).to(b.dtype)
    _, ip, ind, val, n_rows, _ = a
    dtype = torch.promote_types(val.dtype, b.dtype)
    out = torch.zeros((n_rows, b.shape[1]), dtype=dtype, device=b.device)
    if val.shape[0] == 0:
        return out
    rows = _csr_row_ids(ip, val.shape[0], n_rows)
    prod = val.to(dtype)[:, None] * b.to(dtype)[ind.to(torch.int64)]
    return out.index_add_(0, rows, prod)


def _page_gather(pool, table, lengths):
    """Each slot's contiguous KV view from its page-table blocks
    (kokkos.page_gather; positions past lengths are stale)."""
    n_slots, blocks_per_slot = table.shape
    g = _take(pool, table.reshape(-1), 0)
    g = g.reshape((n_slots, blocks_per_slot) + tuple(pool.shape[1:]))
    g = g.movedim(1, 2)
    return g.reshape(n_slots, pool.shape[1],
                     blocks_per_slot * pool.shape[2], pool.shape[3])


def _page_append(pool, table, lengths, kv, block_size):
    """One new KV position per slot into its tail block
    (kokkos.page_append); a new pool, the old one untouched."""
    rows = torch.arange(table.shape[0], device=table.device)
    lengths = lengths.to(torch.int64)
    blk = table[rows, lengths // block_size].to(torch.int64)
    out = pool.clone()
    out[blk, :, lengths % block_size, :] = kv.to(pool.dtype)
    return out


def _page_copy(dst, src, src_ids, dst_ids):
    """Whole KV blocks between arenas (kokkos.page_copy); the block axis
    sits 4 from the end."""
    axis = dst.ndim - 4
    taken = _take(src, src_ids, axis).to(dst.dtype)
    out = dst.clone()
    out[(slice(None),) * axis + (dst_ids.to(torch.int64),)] = taken
    return out


_initialized = False
_device = None
_WEIGHTS = {}


def lapis_initialize(device=None):
    """Load the embedded weights onto ``device`` (default _DEVICE, the
    compile's) — paper 4.4: lapis_initialize allocates and populates the
    globally scoped Views.  Idempotent; naming another device reloads
    them there.  A card that torch cannot see raises: the module never
    carries on on the CPU behind the caller's back."""
    global _initialized, _device
    if _initialized and (device is None or
                         torch.device(device) == torch.device(_device)):
        return
    dev = device if device is not None else _DEVICE
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this module runs on the card ('cuda') but torch sees no CUDA "
            "card; call lapis_initialize(device='cpu') to run it on the "
            "host")
    loaded = {}
    blob = base64.b64decode(_WEIGHTS_B64)
    with np.load(io.BytesIO(blob)) as z:
        for k in z.files:
            t = torch.from_numpy(np.array(z[k]))
            if k in _WEIGHT_DTYPES:
                t = t.view(getattr(torch, _WEIGHT_DTYPES[k]))
            loaded[k] = t.to(dev)
    _WEIGHTS.clear()
    _WEIGHTS.update(loaded)
    _device = dev
    _initialized = True


def lapis_finalize():
    global _initialized, _device
    _WEIGHTS.clear()
    _device = None
    _initialized = False


def _input(x):
    """A graph input as a tensor on the module's device: host arrays are
    copied there, a tensor on another device raises."""
    if isinstance(x, torch.Tensor):
        if x.device.type != torch.device(_device).type:
            raise ValueError(f"input on {x.device}, module loaded on "
                             f"{_device}")
        return x
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(_device)
    return torch.from_numpy(arr).to(_device)
'''

# numpy has no bf16, and npz keeps f16 as it is: both travel as int16
_INT_CODED = {"bfloat16", "float16"}


def _weight_array(value) -> tuple:
    """(host array for the npz blob, dtype name if integer-coded else
    None) of one embedded constant: a tensor is read back from its
    device; bf16 / f16 go as their bits in int16."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        name = str(t.dtype).split(".")[-1]
        if name in _INT_CODED:
            return t.view(torch.int16).numpy(), name
        return t.numpy(), None
    arr = np.ascontiguousarray(value)
    if arr.dtype.name in _INT_CODED:
        return arr.view(np.int16), arr.dtype.name
    return arr, None


def _scalar_literal(value) -> object:
    """A 0-d constant's Python value (inlined into the source, §4.4)."""
    if isinstance(value, torch.Tensor):
        return value.item()
    return np.asarray(value).item()


def emit_python_source(graph: Graph,
                       options: Optional[CompileOptions] = None) -> str:
    """Emit a freestanding torch module implementing ``graph``: library
    semantics (torch ops, no hand kernel), the weights embedded, the
    compile's device recorded as the default for ``lapis_initialize``."""
    options = options or current_options()
    names = ValueNamer()
    names.bind_inputs(graph)
    consts: dict = {}
    coded: dict = {}
    body = [f"{names[v.id]} = _input({names[v.id]})" for v in graph.inputs]

    for op in graph.ops:
        if op.opname in ("kokkos.sync", "kokkos.modify"):
            val = names[op.operands[0].id]
            space = op.attrs.get("space", "device")
            body.append(f"# {op.opname} {val} {{{space}}} — lazy h2d on "
                        "first use (weights loaded by lapis_initialize)")
            continue
        if op.regions:
            # kokkos.fused — or a kokkos.*_parallel nest lowered from one:
            # re-emit the structured sub-op chain the region records
            body.extend(_fused_region_lines(op, names))
            continue
        for r in op.results:
            names.bind_fresh(r)
        if op.opname == "tensor.constant":
            value = op.attrs["value"]
            res = names[op.results[0].id]
            if len(op.results[0].type.shape) == 0:
                # paper §4.4: scalar constants are inlined as literals
                body.append(
                    f"{res} = torch.tensor({_scalar_literal(value)!r}, "
                    f"dtype={_dtype_src(op.results[0].type.dtype)}, "
                    "device=_device)")
            else:
                key = constant_label(len(consts))
                consts[key], dt = _weight_array(value)
                if dt is not None:
                    coded[key] = dt
                body.append(f"{res} = _WEIGHTS[{key!r}]")
            continue
        if op.opname in ("kokkos.range_parallel", "kokkos.team_parallel"):
            # parallel nests take library semantics: emit the original
            # tensor-level op recorded in attrs["src"] (attr-aware ops
            # like softmax go through _src_line via a proxy op)
            src_name = op.attrs.get("src", "")
            fn_src = _SRC_OPS.get(src_name)
            a = [names[o.id] for o in op.operands]
            res = names[op.results[0].id]
            if fn_src is not None:
                body.append(f"{res} = {fn_src.format(*a)}")
            else:
                proxy = Op(src_name, op.operands,
                           [r.type for r in op.results],
                           attrs={k: v for k, v in op.attrs.items()
                                  if k not in ("fn", "tiling", "kind",
                                               "iter_space", "level_map",
                                               "nest", "exec_space",
                                               "collapse", "src", "ops",
                                               "cost")})
                for pr, rr in zip(proxy.results, op.results):
                    names[pr.id] = names[rr.id]
                body.append(_src_line(proxy, names))
            continue
        body.append(_src_line(op, names))

    outs = ", ".join(names[v.id] for v in graph.outputs)
    args = ", ".join(names[v.id] for v in graph.inputs)
    fn_src = [f"def {graph.name}({args}):",
              "    lapis_initialize()"]
    fn_src += ["    " + line for line in body]
    fn_src.append(f"    return {outs}")

    buf = io.BytesIO()
    np.savez(buf, **consts)
    blob = base64.b64encode(buf.getvalue()).decode("ascii")
    # the lines textwrap.wrap(blob, 75) gives (a blob has no spaces), cut
    # by slicing: textwrap takes seconds a megabyte, and a full-width
    # ResNet18 carries ~63 MB of base64
    blob_lines = [blob[i:i + 75] for i in range(0, len(blob), 75)]
    blob_src = "_WEIGHTS_B64 = (\n" + "\n".join(
        f'    "{line}"' for line in blob_lines) + "\n)"
    module_src = "\n".join([
        f"_DEVICE = {options.device!r}   # the compile's device",
        f"_WEIGHT_DTYPES = {coded!r}"])
    prelude = _PRELUDE
    # between-pass analysis diagnostics ride into the emitted module as
    # comments (only attached by verifying compiles)
    diags = getattr(graph, "diagnostics", ())
    if diags:
        prelude += "\n" + "\n".join(f"# analysis: {d.format()}"
                                    for d in diags)
    return "\n\n".join([prelude, module_src, blob_src, "\n".join(fn_src),
                        ""])
