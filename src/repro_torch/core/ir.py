"""SSA tensor IR — the repro analogue of MLIR's linalg-on-tensors level.

The IR is deliberately MLIR-shaped: a ``Graph`` (≈ func.func) holds ``Op``s in
SSA form over ``Value``s typed by ``TensorType``.  Ops are namespaced into
dialects (``linalg.*`` high-level tensor ops, ``sparse.*`` sparse-tensor
storage ops, ``kk.*`` Kokkos-Kernels-style library calls, ``kokkos.*`` the
hierarchical execution-space-aware parallel dialect).  Passes rewrite ops in
place; the emitter walks the final graph and produces an executable
torch callable.

The ``kokkos.*`` dialect (paper §3: "a dialect built on the principles of
the Kokkos ecosystem") is backend-neutral: ``kokkos.range_parallel`` /
``kokkos.team_parallel`` carry a *logical* nest of named levels
(``league``/``team``/``vector`` — :class:`LoopLevel`) plus an
``exec_space`` attr, and the per-backend ``map_parallelism`` pass maps
those logical levels onto whatever physical hierarchy the backend
declares (a :class:`~repro_torch.core.backend.ParallelHierarchy`).  No op in
this file knows about lanes, warps, or grids.

``kokkos.fused`` is the structured fusion op: its body is a
:class:`Region` of ordinary sub-ops (opname + attrs + SSA operand
routing) — IR-visible data the dumper prints and the emitter serializes,
never an opaque Python closure.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch


class MemorySpace(enum.Enum):
    """Kokkos memory spaces.  Every SSA value carries one; the
    ``memory_space_management`` pass assigns them and inserts the lazy
    ``kokkos.sync``/``kokkos.modify`` ops that keep DUAL buffers
    coherent — the single space framework replacing the seed's ad-hoc
    DualView flag plumbing.

    ANY     — unassigned (pre-memory-space pass).
    HOST    — host DRAM (numpy side of a DualView).
    DEVICE  — accelerator memory (the resolved backend's exec space).
    DUAL    — mirrored host+device buffer with lazy sync (LAPIS::DualView).
    SCRATCH — fast per-team memory (Kokkos scratch; VMEM on TPU,
              shared memory on GPU).
    SMEM    — scalar memory (Pallas scalar prefetch operands).
    """

    ANY = "any"
    HOST = "host"
    DEVICE = "device"
    DUAL = "dual"
    SCRATCH = "scratch"
    SMEM = "smem"


@dataclasses.dataclass(frozen=True)
class LoopLevel:
    """One level of a *logical* ``kokkos.*`` parallel nest.

    ``name`` is backend-neutral — ``league`` (outer blocks), ``team``
    (cooperating workers), ``vector`` (innermost SIMD lanes), or
    ``range`` (a flat 1-D RangePolicy).  The ``map_parallelism`` pass
    later binds each logical level to a physical level of the backend's
    declared :class:`~repro_torch.core.backend.ParallelHierarchy`; until then
    the nest says only *what* parallelism exists, never *where* it runs
    (the paper's nesting-depth → policy decision table, §4.2).
    """

    name: str
    trip: int

    def __str__(self) -> str:
        return f"{self.name}:{self.trip}"

    __repr__ = __str__          # compact IR dumps: nest=(league:4, vector:128)


@dataclasses.dataclass(frozen=True)
class SparseEncoding:
    """Structured sparse-tensor encoding (the MLIR ``#sparse_tensor``
    attribute analogue; stats are the paper's Table 6.1 per-matrix
    metadata).

    A ``TensorType`` carrying one denotes the whole sparse matrix as a
    single composite SSA value — ``sparse.pack`` assembles it from the
    loose indptr/indices/values tensors, ``sparse.convert`` changes its
    storage ``format`` (e.g. CSR→ELL for the TPU lane-parallel kernel).
    """

    format: str = "csr"                  # csr | ell | coo
    pos_width: int = 32                  # indptr (positions) integer width
    crd_width: int = 32                  # indices (coordinates) width
    nnz: Optional[int] = None            # total stored entries
    nnz_mean: Optional[float] = None     # avg entries/row (§4.2 heuristic)
    max_nnz_row: Optional[int] = None    # longest row (static ELL width)

    def __str__(self) -> str:
        s = (f"#sparse<{self.format}, pos=i{self.pos_width}, "
             f"crd=i{self.crd_width}")
        if self.nnz is not None:
            s += f", nnz={self.nnz}"
        if self.nnz_mean is not None:
            s += f", nnz/row={self.nnz_mean:.2f}"
        if self.max_nnz_row is not None:
            s += f", max/row={self.max_nnz_row}"
        return s + ">"

    def with_format(self, format: str) -> "SparseEncoding":
        return dataclasses.replace(self, format=format)


@dataclasses.dataclass(frozen=True)
class TensorType:
    shape: tuple
    dtype: str
    memory_space: MemorySpace = MemorySpace.ANY
    # Sparse tensors carry a structured encoding; dense tensors None.
    encoding: Optional[SparseEncoding] = None

    def __str__(self) -> str:
        dims = "x".join(str(d) for d in self.shape) if self.shape else "scalar"
        s = f"tensor<{dims}x{self.dtype}"
        if self.encoding:
            s += f", {self.encoding}"
        if self.memory_space is not MemorySpace.ANY:
            s += f", #{self.memory_space.value}"
        return s + ">"

    @property
    def is_sparse(self) -> bool:
        return self.encoding is not None

    @property
    def nbytes(self) -> int:
        """Stored bytes.  Sparse types count their actual storage, not
        the dense bound: CSR is values + coordinates + positions; padded
        ELL is the rectangular values/indices/valid planes (no pos
        array), whose width is the 8-padded max_nnz_row."""
        itemsize = dtype_itemsize(self.dtype)
        enc = self.encoding
        if enc is not None and enc.format == "ell" and \
                enc.max_nnz_row is not None:
            width = ell_storage_width(enc.max_nnz_row)
            rows = self.shape[0] if self.shape else 1
            return rows * width * (itemsize + enc.crd_width // 8 + 1)
        if enc is not None and enc.nnz is not None:
            pos = (self.shape[0] + 1 if self.shape else 1) * \
                (enc.pos_width // 8)
            return enc.nnz * (itemsize + enc.crd_width // 8) + pos
        return int(np.prod(self.shape, initial=1)) * itemsize

    def with_space(self, space: MemorySpace) -> "TensorType":
        return dataclasses.replace(self, memory_space=space)


def ell_storage_width(max_nnz_row, pad_to: int = 8) -> int:
    """Padded ELL storage width: ``max_nnz_row`` rounded up to the
    ``pad_to`` unit, floor one unit.  THE single definition of the
    layout's width — ``TensorType.nbytes``, the runtime conversion
    (``kernels/spmv.csr_to_ell``) and the C++ translate stage all call
    it, and the freestanding Python prelude in ``emitter._PRELUDE``
    inlines the same formula (it cannot import this module)."""
    return max(-(-max(int(max_nnz_row or 0), 1) // pad_to) * pad_to,
               pad_to)


def _np_dtype(dtype: str):
    return {"bf16": np.float32, "f32": np.float32}.get(dtype, dtype)


def dtype_itemsize(dtype: str) -> int:
    """Bytes per element, correct for dtypes numpy lacks (bf16 is 2 bytes;
    ``_np_dtype`` maps it to float32 only for *computation* compat, which
    must not inflate VMEM footprint heuristics 2×)."""
    if dtype in ("bf16", "bfloat16", "float16", "f16"):
        return 2
    return np.dtype(_np_dtype(dtype)).itemsize


_value_counter = [0]


class Value:
    """An SSA value."""

    __slots__ = ("id", "type", "producer", "name")

    def __init__(self, type: TensorType, producer: Optional["Op"] = None,
                 name: Optional[str] = None):
        _value_counter[0] += 1
        self.id = _value_counter[0]
        self.type = type
        self.producer = producer
        self.name = name

    def __repr__(self) -> str:
        return f"%{self.name or self.id}"

    @property
    def shape(self) -> tuple:
        return self.type.shape

    @property
    def dtype(self) -> str:
        return self.type.dtype


class Region:
    """A single-block region owned by an Op (≈ an MLIR region).

    ``inputs`` are the block arguments — fresh :class:`Value`\\ s that
    correspond **positionally** to the owning op's operands (the operand
    routing of the fused body); ``ops`` is the structured list of sub-op
    records (each an ordinary :class:`Op` carrying opname + attrs + SSA
    operand routing); ``outputs`` are the yielded values.  Everything in
    a region is plain data: the IR dumper prints it (``_print_op``) and
    the emitter serializes it — no Python closures.
    """

    __slots__ = ("inputs", "ops", "outputs")

    def __init__(self, inputs: Sequence[Value],
                 ops: Optional[list] = None,
                 outputs: Optional[list] = None):
        self.inputs = list(inputs)
        self.ops: list = list(ops or [])
        self.outputs: list = list(outputs or [])

    def walk(self) -> Iterable["Op"]:
        for op in self.ops:
            yield op
            for region in op.regions:
                yield from region.walk()


class Op:
    """An IR operation: ``results = opname(operands) {attrs}`` (+ regions)."""

    __slots__ = ("opname", "operands", "attrs", "results", "regions")

    def __init__(self, opname: str, operands: Sequence[Value],
                 result_types: Sequence[TensorType],
                 attrs: Optional[dict] = None,
                 regions: Optional[list] = None):
        self.opname = opname
        self.operands = list(operands)
        self.attrs = dict(attrs or {})
        self.results = [Value(t, producer=self) for t in result_types]
        self.regions = list(regions or [])

    @property
    def dialect(self) -> str:
        return self.opname.split(".", 1)[0]

    def __repr__(self) -> str:
        res = ", ".join(map(repr, self.results))
        ops = ", ".join(map(repr, self.operands))
        s = f"{res} = {self.opname}({ops})" if self.results else \
            f"{self.opname}({ops})"
        if self.attrs:
            printable = {k: v for k, v in self.attrs.items()
                         if not callable(v)
                         and not isinstance(v, (np.ndarray, torch.Tensor))}
            if printable:
                s += " {" + ", ".join(f"{k}={v!r}" for k, v in
                                      sorted(printable.items())) + "}"
        return s


class Graph:
    """A function-level container of ops in SSA order (≈ func.func)."""

    def __init__(self, name: str, inputs: Sequence[Value],
                 ops: Optional[list] = None,
                 outputs: Optional[list] = None):
        self.name = name
        self.inputs = list(inputs)
        self.ops: list[Op] = list(ops or [])
        self.outputs: list[Value] = list(outputs or [])

    # -- construction -------------------------------------------------------
    def add(self, op: Op) -> Op:
        self.ops.append(op)
        return op

    # -- traversal ----------------------------------------------------------
    def walk(self) -> Iterable[Op]:
        for op in self.ops:
            yield op
            for region in op.regions:
                yield from region.walk()

    def values(self) -> Iterable[Value]:
        seen = set()
        for v in self.inputs:
            if v.id not in seen:
                seen.add(v.id)
                yield v
        for op in self.walk():
            for v in op.results:
                if v.id not in seen:
                    seen.add(v.id)
                    yield v

    def users(self) -> dict:
        """value.id -> list of (op, operand_index) using it (incl. regions)."""
        out: dict = {}
        for op in self.walk():
            for i, v in enumerate(op.operands):
                out.setdefault(v.id, []).append((op, i))
        for i, v in enumerate(self.outputs):
            out.setdefault(v.id, []).append((None, i))
        return out

    def replace_op(self, old: Op, new_ops: Sequence[Op],
                   value_map: dict) -> None:
        """Replace ``old`` with ``new_ops``; rewire uses via ``value_map``
        (old Value -> new Value)."""
        idx = self.ops.index(old)
        self.ops[idx:idx + 1] = list(new_ops)
        self._rewire(value_map)

    def _rewire(self, value_map: dict) -> None:
        mapping = {ov.id: nv for ov, nv in value_map.items()}
        for op in self.walk():
            op.operands = [mapping.get(v.id, v) for v in op.operands]
        self.outputs = [mapping.get(v.id, v) for v in self.outputs]

    def dce(self) -> int:
        """Dead code elimination; returns number of removed ops."""
        removed = 0
        changed = True
        while changed:
            changed = False
            used = {v.id for v in self.outputs}
            for op in self.walk():
                for v in op.operands:
                    used.add(v.id)
            keep = []
            for op in self.ops:
                side_effecting = op.opname in SIDE_EFFECTING_OPS
                if side_effecting or any(r.id in used for r in op.results):
                    keep.append(op)
                else:
                    removed += 1
                    changed = True
            self.ops = keep
        return removed

    # -- printing -----------------------------------------------------------
    def __str__(self) -> str:
        lines = []
        args = ", ".join(f"{v!r}: {v.type}" for v in self.inputs)
        lines.append(f"func @{self.name}({args}) {{")
        for op in self.ops:
            lines.extend(_print_op(op, indent=1))
        outs = ", ".join(map(repr, self.outputs))
        lines.append(f"  return {outs}")
        lines.append("}")
        return "\n".join(lines)


def _print_op(op: Op, indent: int):
    pad = "  " * indent
    lines = [pad + repr(op)]
    for region in op.regions:
        args = ", ".join(f"{v!r}: {v.type}" for v in region.inputs)
        lines.append(pad + f"  region ({args}) {{")
        for inner in region.ops:
            lines.extend(_print_op(inner, indent + 2))
        outs = ", ".join(map(repr, region.outputs))
        lines.append(pad + f"    yield {outs}")
        lines.append(pad + "  }")
    return lines


# Ops that must never be DCE'd (memory-model bookkeeping).
SIDE_EFFECTING_OPS = {"kokkos.sync", "kokkos.modify"}


# --------------------------------------------------------------------------
# Dialect op sets (used by passes to decide what they own).
# --------------------------------------------------------------------------
LINALG_MATMUL_LIKE = {
    "linalg.matmul", "linalg.batch_matmul", "linalg.gemv", "linalg.dot",
}
LINALG_ELEMENTWISE = {
    "linalg.map",       # generic elementwise with attrs["fn"] (python name)
    "linalg.add", "linalg.sub", "linalg.mul", "linalg.div", "linalg.maximum",
    "linalg.relu", "linalg.gelu", "linalg.silu", "linalg.sigmoid",
    "linalg.tanh", "linalg.exp", "linalg.neg", "linalg.sqrt", "linalg.rsqrt",
    "linalg.power",
}
LINALG_REDUCTION = {"linalg.reduce_sum", "linalg.reduce_max", "linalg.mean",
                    "linalg.softmax"}
LINALG_SPARSE = {"linalg.spmv_csr", "linalg.spmm_csr"}
SPARSE_OPS = {"sparse.pack", "sparse.convert"}
LINALG_SHAPE = {"tensor.reshape", "tensor.transpose", "tensor.slice",
                "tensor.concat", "tensor.broadcast", "tensor.cast",
                "tensor.constant", "tensor.pad", "tensor.gather"}
KK_OPS = {"kk.gemm", "kk.gemv", "kk.batched_gemm", "kk.spmv", "kk.spmm",
          "kk.attention", "kk.rwkv6_scan", "kk.rglru_scan", "kk.conv2d"}
# Block-paged KV-cache ops (the serving engine's cache plumbing).  The
# tensor-level forms are backend-neutral; ``paged_to_kokkos`` lowers them
# to the kokkos.* dialect with a logical nest + level map + SCRATCH-typed
# staging, so the paged decode step is IR all the way down (never an
# opaque Python closure).
PAGED_OPS = {"paged.gather", "paged.append"}
KOKKOS_PAGED_OPS = {"kokkos.page_gather", "kokkos.page_append"}
# Legal values of the ``direction`` attr on kokkos.page_copy (and the
# tensor-level paged.copy/swap_* it lowers from): which engine path —
# CoW fork, preemption swap-out, resume swap-in — emitted the copy.
# The dialect verifier (repro_torch.core.analysis) rejects anything else.
PAGE_COPY_DIRECTIONS = ("copy", "swap_out", "swap_in")
# The hierarchical parallel dialect: logical nests awaiting (or carrying)
# a per-backend level mapping, the IR-visible fused-elementwise region op
# (its body is a Region of sub-op records, not a closure), plus the
# memory-space coherence ops.
KOKKOS_PARALLEL_OPS = {"kokkos.range_parallel", "kokkos.team_parallel"}
KOKKOS_FUSED = "kokkos.fused"
KOKKOS_OPS = KOKKOS_PARALLEL_OPS | KOKKOS_PAGED_OPS | \
    {KOKKOS_FUSED, "kokkos.sync", "kokkos.modify"}
