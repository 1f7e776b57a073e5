"""Mapped ``kokkos.*_parallel`` nests on the card — the port of the
reference's ``kernels/generic.py`` (``block_map`` / ``block_map_region``).

The map_parallelism pass binds a logical league/team/vector nest onto the
H100 hierarchy (grid/block/warp) and picks ``tiling["block"]``; neither
kernel's launch follows it.  Two kernels run the nests:

* :func:`block_map_region` — a map nest, fused (a ``kokkos.fused`` region)
  or not (a one-op region made by :func:`one_op_region`), as a CUDA kernel
  generated from the region (``kernels/codegen.py``) around the
  hand-written skeleton ``csrc/block_map.cuh``: a flat stream of 16-byte
  vectors walked by a grid sized to the card, launched by the plan
  :func:`map_plan` mirrors.  Generated libraries are built by nvcc at
  first use and cached by the hash of their source.
* :func:`row_softmax` — a ``kind='reduce'`` nest (last-axis softmax) on
  the fixed ``csrc/row_softmax.cu``: rows read once into registers by
  16-byte loads, launched by the plan :func:`softmax_plan` mirrors.

Each wrapper runs its plain torch version when — and only when — its
tensors lie on the CPU; on CUDA tensors it launches its kernel or raises.
``launches`` and ``plain_calls`` on each wrapper count the two.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core import refs
from repro_torch.core.ir import Op, Region, Value
from repro_torch.core.tracer import dtype_name, torch_dtype
from repro_torch.kernels import _build, codegen, row_reduce


def one_op_region(op: Op) -> Region:
    """An unfused map nest as a one-op region: the nest's ``src`` opname
    over fresh block arguments mirroring its operands, with the
    exponent a power's nest carries (the nest's ``fn`` is a torch
    closure, which no kernel can be made from)."""
    src = op.attrs.get("src", "")
    if src not in codegen.SPELLED:
        raise NotImplementedError(
            f"no generated kernel for an unfused {src!r} nest (no C++ "
            "spelling)")
    args = [Value(o.type) for o in op.operands]
    attrs = {"exponent": float(op.attrs["exponent"])} \
        if src == "linalg.power" else {}
    sub = Op(src, args, [op.results[0].type], attrs=attrs)
    return Region(inputs=args, ops=[sub], outputs=[sub.results[0]])


MAP_THREADS = 256        # a block of the map kernel (csrc/block_map.cuh)
MAP_BLOCKS_PER_SM = 4    # resident blocks the grid is sized to
MAP_MAX_UNROLL = 4       # most vectors of every operand in flight a thread
MAP_INFLIGHT_BYTES = 128  # loaded bytes a thread holds a step
MAP_PLAN_FIELDS = ("vec", "unroll", "threads", "grid", "vectors", "tail")


def map_plan(n: int, itemsizes: Sequence[int], aligned: bool,
             sm_count: int) -> dict:
    """The launch of a mapped nest over ``n`` elements whose operands,
    then output, have ``itemsizes`` bytes an element — the twin of
    ``plan`` in ``csrc/block_map.cuh`` (exported from every generated
    library as ``lapis_map_plan``).  A thread takes ``vec`` elements a
    step, 16 bytes of the widest (1 where some base is off 16 bytes: not
    ``aligned``), ``unroll`` vectors of every operand at a time (as many
    as ``MAP_INFLIGHT_BYTES`` of loaded operands hold, 1 to
    ``MAP_MAX_UNROLL``); ``grid`` blocks of ``threads``, at most
    ``MAP_BLOCKS_PER_SM`` an SM, walk the ``vectors`` by a grid-stride
    loop; the last ``tail`` elements (``n`` mod ``vec``) take scalar
    loads in the same launch."""
    vec = 16 // max(itemsizes) if aligned else 1
    unroll = min(max(MAP_INFLIGHT_BYTES // (vec * sum(itemsizes[:-1])), 1),
                 MAP_MAX_UNROLL)
    vectors = n // vec
    grid = -(-vectors // (MAP_THREADS * unroll))
    if grid < 1 and n > 0:
        grid = 1
    return dict(vec=vec, unroll=unroll, threads=MAP_THREADS,
                grid=min(grid, sm_count * MAP_BLOCKS_PER_SM),
                vectors=vectors, tail=n - vectors * vec)


def c_map_plan(lib, n: int, itemsizes: Sequence[int], aligned: bool,
               sm_count: int) -> dict:
    """The plan a generated library's exported ``lapis_map_plan``
    computes, in :func:`map_plan`'s form."""
    fn = lib.lapis_map_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(MAP_PLAN_FIELDS))()
    rc = fn(n, max(itemsizes), sum(itemsizes[:-1]), int(aligned), sm_count,
            out)
    if rc != 0:
        raise ValueError(f"lapis_map_plan({n}, {max(itemsizes)}): "
                         f"error {rc}")
    return dict(zip(MAP_PLAN_FIELDS, out))


_REGION_LIBS: dict = {}     # (region, in dtypes, out dtype) -> CDLL


def region_kernel(region, in_dtypes: Sequence[str],
                  out_dtype: str) -> _build.KernelSource:
    """The build record of the generated kernel for ``region``."""
    return _build.KernelSource(
        "region", codegen.kernel_source(region, in_dtypes, out_dtype))


def region_library(region, in_dtypes: Sequence[torch.dtype],
                   out_dtype: torch.dtype) -> ctypes.CDLL:
    """The generated library for ``region`` over operands of
    ``in_dtypes`` producing ``out_dtype``, built at first use."""
    key = (region, tuple(in_dtypes), out_dtype)
    lib = _REGION_LIBS.get(key)
    if lib is None:
        lib = _REGION_LIBS[key] = _build.load(region_kernel(
            region, [dtype_name(d) for d in in_dtypes],
            dtype_name(out_dtype)))
        lib.lapis_region_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
            ctypes.c_void_p]
        lib.lapis_region_launch.restype = ctypes.c_int
    return lib


def block_map_region(region, args: Sequence[torch.Tensor], out_shape: tuple,
                     out_dtype, *, block: tuple) -> torch.Tensor:
    """Execute a whole region as ONE kernel: block arguments bind to the
    operands, every sub-op runs on values held in registers, and only the
    yielded value is written out.  A chain of N fused elementwise ops
    therefore costs one launch and no HBM round trips for
    intermediates.  ``block`` is the nest's ``tiling["block"]``, kept
    because the reference's signature has it; it does not steer the
    launch, which :func:`map_plan` takes from the element count, the
    dtypes, the alignment and the card."""
    out_dtype = torch_dtype(out_dtype)
    args = list(args)
    if _build.on_cpu(args, "block_map_region"):
        block_map_region.plain_calls += 1
        return refs.region_ref(region)(*args).to(out_dtype)
    for a in args:
        if tuple(a.shape) != tuple(out_shape):
            raise ValueError(f"block_map_region: operand shape "
                             f"{tuple(a.shape)} != iteration space "
                             f"{tuple(out_shape)}")
    args = [a.contiguous() for a in args]
    lib = region_library(region, [a.dtype for a in args], out_dtype)
    out = torch.empty(tuple(out_shape), dtype=out_dtype,
                      device=args[0].device if args else "cuda")
    ptrs = (ctypes.c_void_p * (len(args) + 1))(
        *[a.data_ptr() for a in args], out.data_ptr())
    _build.check(lib.lapis_region_launch(
        ptrs, out.numel(),
        torch.cuda.current_stream(out.device).cuda_stream),
        "block_map_region")
    block_map_region.launches += 1
    return out


block_map_region.launches = 0
block_map_region.plain_calls = 0


_SOFTMAX_FNS = {torch.float32: "lapis_row_softmax_f32",
                torch.bfloat16: "lapis_row_softmax_bf16"}
_SOFTMAX_LAUNCHERS: dict = {}     # dtype -> ctypes function


def softmax_kernel() -> _build.KernelSource:
    """The build record of ``csrc/row_softmax.cu``."""
    return _build.KernelSource("row_softmax", _build.csrc("row_softmax.cu"))


def softmax_plan(rows: int, cols: int, dtype: torch.dtype, sm_count: int,
                 aligned: bool = True) -> dict:
    """The launch ``csrc/row_softmax.cu`` makes for ``rows`` rows of
    ``cols`` values of ``dtype`` on a card of ``sm_count`` SMs: the
    register path for rows of at most ``SOFTMAX_MAX_COLS`` (the pass's
    limit), :func:`row_reduce.row_plan`."""
    return row_reduce.row_plan(rows, cols, dtype.itemsize, aligned, sm_count,
                               row_reduce.SOFTMAX_MAX_COLS)


def _softmax_launcher(dtype: torch.dtype):
    fn = _SOFTMAX_LAUNCHERS.get(dtype)
    if fn is None:
        if dtype not in _SOFTMAX_FNS:
            raise TypeError(f"row_softmax takes float32 or bfloat16, "
                            f"not {dtype}")
        fn = getattr(_build.load(softmax_kernel()), _SOFTMAX_FNS[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SOFTMAX_LAUNCHERS[dtype] = fn
    return fn


def row_softmax(x: torch.Tensor, *, axis: int = -1,
                block: tuple = ()) -> torch.Tensor:
    """Softmax over the last axis, each row read once into registers
    (:func:`softmax_plan`; wider or unaligned rows take a block-stride
    loop).  ``block`` is the nest's tiling; its last extent must hold
    whole rows (the linalg_to_parallel pass admits rows of at most 1024)."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError(f"row_softmax reduces the last axis, not {axis}")
    if _build.on_cpu([x], "row_softmax"):
        row_softmax.plain_calls += 1
        return refs.softmax(x, -1)
    cols = x.shape[-1] if x.ndim else 1
    if block and block[-1] < cols:
        raise ValueError(f"row_softmax: block {tuple(block)} splits rows "
                         f"of {cols}")
    fn = _softmax_launcher(x.dtype)
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // max(cols, 1)
    _build.check(fn(x.data_ptr(), y.data_ptr(), rows, cols,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "row_softmax")
    row_softmax.launches += 1
    return y


row_softmax.launches = 0
row_softmax.plain_calls = 0
