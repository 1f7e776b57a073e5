"""The Kokkos emitter, adapted (paper §4.4): the executable path.

``build_callable`` turns a lowered graph into a torch callable (the
KokkosBackend / RefBackend-replacement path of the paper's §5 pipeline).
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

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import refs
from repro_torch.core.dualview import DualView
from repro_torch.core.ir import Graph, Op
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
