"""lapis-translate: freestanding Kokkos C++ from post-pipeline kokkos.* IR.

The paper's productivity claim ends in a C++ translation unit: LAPIS
lowers a traced model through ``lapis-opt`` and then ``lapis-translate``
walks the structured IR once, op by op, and prints Kokkos source — "a
C++ file with no dependencies besides Kokkos, all model weights included
as constant arrays" (§4.4).  This module is that stage for the repro:
:func:`emit_cpp_source` takes a *lowered* :class:`~repro_torch.core.ir.Graph`
(every construct the ``kokkos.*`` dialect has) and emits one compilable,
self-contained ``.cpp`` unit:

* ``kokkos.range_parallel``            → ``Kokkos::parallel_for`` over a
  ``RangePolicy`` (or ``MDRangePolicy`` for collapsed multi-dim nests on
  library backends — the vendor library owns that mapping, so the
  spelling is a flat policy);
* ``kokkos.team_parallel``             → a ``TeamPolicy`` launch with
  nested ``TeamThreadRange`` / ``ThreadVectorRange`` loops following the
  nest's declared levels and ``attrs["tiling"]`` block shapes;
* ``kokkos.fused`` regions             → ONE lambda body replaying the
  region's recorded sub-op chain with scratch scalar intermediates
  (registers — the per-element analogue of team scratch residency);
* ``kokkos.sync`` / ``kokkos.modify``  → ``Kokkos::DualView``
  ``sync_device()`` / ``modify_*()`` calls on the embedded weights;
* ``sparse.pack`` / ``sparse.convert`` → CSR/ELL view structs (the
  composite sparse SSA value as a C++ aggregate) with a layout-change
  kernel;
* ``kk.gemm`` / ``kk.gemv``            → TeamPolicy matmul nests shaped
  by the mapped tiling;
* ``kk.spmv`` / ``kk.spmm``            → the §4.2 row-loop kernels
  (team loop over row blocks, ThreadVectorRange over row entries),
  dispatching on the operand's storage format (csr vs ell).

Per-backend spelling (execution space, layout) comes from the backend's
:class:`~repro_torch.core.backend.TranslateTarget` — ``Kokkos::Serial`` for
the host-space ``loops`` backend, ``Kokkos::DefaultExecutionSpace`` for
device backends — so the same walk serializes every registered backend.

Anything the dialect cannot express as data (a Python closure in
``linalg.map``, an op with no C++ spelling yet) raises
:class:`TranslateError` — by design: this layer is where any remaining
closure leakage in the IR is forced into the open.

Each unit carries THREE entry surfaces:

* the typed entry function (the paper's ``kokkosModule.forward``);
* a ``main`` that runs it on zero-filled inputs and prints a checksum;
* a C-ABI harness — ``extern "C" void lapis_run(const float** ins,
  float** outs)`` plus shape/arity/dtype descriptor functions — so the
  native build (``repro_torch.core.native``) can ctypes-load the compiled
  shared object and push the *same* test inputs through the compiled
  torch callable and the native binary (the differential oracle).  ``lapis_initialize``
  is idempotent so a loaded unit survives repeated entry.

Emitted text is deterministic (walk-ordered value names from
:class:`~repro_torch.core.irwalk.ValueNamer`, sorted attr printing), which is
what the golden-file tests in ``tests/test_translate.py`` pin, and the
unit compiles, links and *runs* against the executable serial Kokkos
subset in ``tests/kokkos_stub/`` (or a real Kokkos install via
``$KOKKOS_ROOT`` — see :mod:`repro_torch.core.native`).

This is the reference package's translate stage, copied onto the port's
IR.  The unit's text is the reference's byte for byte on the host
backends (``loops``, ``openmp``); the harness comments keep the
reference's wording.  Weights may arrive as torch tensors on any device:
they are read back to the host once, at emission, and bf16 / f16 weights
are embedded as ``float`` (the unit computes in f32).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ir import Graph, Op, ell_storage_width
from repro_torch.core.irwalk import ValueNamer, bind_region_args, constant_label
from repro_torch.core.options import CompileOptions, current_options


class TranslateError(NotImplementedError):
    """The graph contains a construct lapis-translate cannot serialize to
    Kokkos C++ (e.g. an op with no spelling, or a Python closure that
    leaked into the IR instead of structured data)."""


# ---------------------------------------------------------------------------
# type + literal spelling
# ---------------------------------------------------------------------------

_CTYPE = {
    "float32": "float", "f32": "float",
    "float64": "double", "f64": "double",
    # bf16/f16 compute in float in the generated unit (comment notes it)
    "bf16": "float", "bfloat16": "float", "float16": "float", "f16": "float",
    "int32": "int32_t", "i32": "int32_t",
    "int64": "int64_t", "i64": "int64_t",
    "bool": "bool",
}


def _ctype(dtype: str) -> str:
    try:
        return _CTYPE[str(dtype)]
    except KeyError:
        raise TranslateError(f"no C++ type spelling for dtype {dtype!r}")


def _lit(x, ctype: str = "float") -> str:
    """One scalar as a C++ literal (floats round-trip via repr)."""
    if ctype in ("float", "double"):
        v = float(x)
        if math.isinf(v):
            return "INFINITY" if v > 0 else "-INFINITY"
        if math.isnan(v):
            return "NAN"
        s = repr(v)
        if "e" not in s and "." not in s:
            s += ".0"
        return s + ("f" if ctype == "float" else "")
    if ctype == "bool":
        return "true" if x else "false"
    return str(int(x))


def _host_array(value) -> np.ndarray:
    """A constant's value as a host numpy array: a tensor is read back
    from its device, and bf16 / f16 (which the unit spells ``float``)
    widen to f32 exactly."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _view(rank: int, ctype: str) -> str:
    if rank < 1 or rank > 4:
        raise TranslateError(f"no Kokkos view alias for rank-{rank} tensors")
    return f"LapisView{rank}<{ctype}>"


# The C-ABI dtype descriptor: ``lapis_input_dtype(i)`` /
# ``lapis_output_dtype()`` return these codes so the ctypes loader
# (repro_torch.core.native) knows how to reinterpret each ``lapis_run`` buffer
# pointer.  Kept as the single source of truth — native.py imports it.
CABI_DTYPE_CODES = {"float": 0, "int32_t": 1, "int64_t": 2, "bool": 3}
CABI_MAX_RANK = 4


def _dtype_code(ctype: str) -> int:
    try:
        return CABI_DTYPE_CODES[ctype]
    except KeyError:
        raise TranslateError(
            f"no C-ABI dtype code for element type {ctype!r}")


def _flat_index(shape) -> str:
    """Dense row-major flat-index expression over ``i0..iN`` vars."""
    expr = "i0"
    for d in range(1, len(shape)):
        expr = f"({expr}) * {shape[d]} + i{d}"
    return expr


# ---------------------------------------------------------------------------
# scalar expression vocabulary (the elementwise dialect, spelled in C++)
# ---------------------------------------------------------------------------

# {0}, {1} are operand element expressions.  Helper functions (lapis_*)
# are emitted into the prelude only when referenced.
_CPP_SCALAR = {
    "linalg.add": "({0} + {1})",
    "linalg.sub": "({0} - {1})",
    "linalg.mul": "({0} * {1})",
    "linalg.div": "({0} / {1})",
    "linalg.maximum": "fmaxf({0}, {1})",
    "linalg.relu": "lapis_relu({0})",
    "linalg.gelu": "lapis_gelu({0})",
    "linalg.silu": "lapis_silu({0})",
    "linalg.sigmoid": "lapis_sigmoid({0})",
    "linalg.tanh": "tanhf({0})",
    "linalg.exp": "expf({0})",
    "linalg.neg": "(-{0})",
    "linalg.sqrt": "sqrtf({0})",
    "linalg.rsqrt": "(1.0f / sqrtf({0}))",
}

_HELPERS = {
    "lapis_relu": (
        "KOKKOS_INLINE_FUNCTION float lapis_relu(float x) "
        "{ return x > 0.0f ? x : 0.0f; }"),
    "lapis_sigmoid": (
        "KOKKOS_INLINE_FUNCTION float lapis_sigmoid(float x) "
        "{ return 1.0f / (1.0f + expf(-x)); }"),
    "lapis_silu": (
        "KOKKOS_INLINE_FUNCTION float lapis_silu(float x) "
        "{ return x / (1.0f + expf(-x)); }"),
    "lapis_gelu": (
        "KOKKOS_INLINE_FUNCTION float lapis_gelu(float x) {\n"
        "  // tanh approximation (matches jax.nn.gelu approximate=True)\n"
        "  const float c = 0.7978845608028654f;  // sqrt(2/pi)\n"
        "  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)"
        "));\n"
        "}"),
}

_SPARSE_STRUCTS = """\
// Composite sparse SSA values as C++ aggregates: ``sparse.pack`` builds a
// LapisCsr, ``sparse.convert`` a padded LapisEll (the storage the §4.2
// lane-parallel kernels want).
struct LapisCsr {
  LapisView1<int32_t> rowptr;   // (n_rows + 1,)
  LapisView1<int32_t> colidx;   // (nnz,)
  LapisView1<float> values;     // (nnz,)
  int32_t n_rows;
  int32_t n_cols;
};

struct LapisEll {
  LapisView2<float> values;     // (n_rows, width)
  LapisView2<int32_t> colidx;   // (n_rows, width)
  LapisView2<bool> valid;       // (n_rows, width)
  int32_t n_rows;
  int32_t n_cols;
};"""


# the one shared definition of the padded ELL storage width — emitted
# kernels must read exactly the width the runtime packs
_ell_width = ell_storage_width


def _fmt_attr(v) -> str:
    if isinstance(v, dict):
        inner = ", ".join(f"{k}={_fmt_attr(v[k])}" for k in sorted(v))
        return "{" + inner + "}"
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(_fmt_attr(x) for x in v) + ")"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


_COMMENT_ATTRS = ("src", "kind", "exec_space", "level_map", "nest",
                  "tiling", "collapse", "from", "to", "max_nnz_row",
                  "format", "axis", "space", "lazy", "cost",
                  "block_size", "direction", "shared_block_ids",
                  "fork_block_ids")


def _op_comment(op: Op, namer: ValueNamer) -> str:
    res = ", ".join("%" + namer.name(r) for r in op.results)
    args = ", ".join("%" + namer.name(o) for o in op.operands)
    s = f"{res} = {op.opname}({args})" if op.results else \
        f"{op.opname}({args})"
    shown = {k: op.attrs[k] for k in _COMMENT_ATTRS if k in op.attrs}
    if shown:
        s += "  {" + ", ".join(f"{k}={_fmt_attr(v)}"
                               for k, v in sorted(shown.items())) + "}"
    return "// " + s


# ---------------------------------------------------------------------------
# the emitter
# ---------------------------------------------------------------------------

class _CppEmitter:
    def __init__(self, graph: Graph, options: CompileOptions):
        self.graph = graph
        self.options = options
        self.backend = options.backend()
        self.target = self.backend.resolve_translate_target()
        self.namer = ValueNamer()
        self.body: list = []            # lines inside the entry function
        self.weights: list = []         # (label, np.ndarray, IR dtype)
        self.dual_of: dict = {}         # value.id -> weight label
        self.helpers: set = set()
        self.needs_sparse = False
        self.kernel_n = 0

    # -- small emission helpers --------------------------------------------

    def w(self, line: str = "", indent: int = 1):
        self.body.append(("  " * indent + line).rstrip())

    def kernel_label(self, op: Op, res: str) -> str:
        self.kernel_n += 1
        tag = op.attrs.get("src", op.opname).split(".")[-1]
        return f"{self.graph.name}_{res}_{tag}"

    def helper(self, expr_tmpl: str) -> str:
        for name in _HELPERS:
            if name + "(" in expr_tmpl:
                self.helpers.add(name)
        return expr_tmpl

    def elem(self, value, idx: str) -> str:
        """Element access expression for an SSA value at index vars."""
        name = self.namer.name(value)
        return name if not value.type.shape else f"{name}({idx})"

    def alloc(self, value, name: Optional[str] = None) -> str:
        """Emit the result-view allocation for ``value``; returns name."""
        name = name or self.namer.name(value)
        shape = value.type.shape
        ct = _ctype(value.type.dtype)
        dims = ", ".join(str(d) for d in shape)
        self.w(f"{_view(len(shape), ct)} {name}(\"{name}\", {dims});")
        return name

    def scalar_expr(self, opname: str, attrs: dict,
                    operand_exprs: list) -> str:
        tmpl = _CPP_SCALAR.get(opname)
        if tmpl is None:
            raise TranslateError(
                f"no scalar C++ spelling for {opname} inside a parallel "
                f"body (attrs={sorted(attrs)})")
        return self.helper(tmpl).format(*operand_exprs)

    # -- region replay ------------------------------------------------------

    def region_lines(self, op: Op, idx: str, out_access: str,
                     ctype: str, indent: int):
        """Replay a ``kokkos.fused`` region as one lambda body: sub-op
        records become scratch scalar intermediates, the yielded value is
        assigned to the output element."""
        region = op.regions[0]
        local = {ba_id: f"{name}({idx})" if idx else name
                 for ba_id, name in bind_region_args(op, self.namer).items()}
        chain = " -> ".join(s.opname for s in region.ops)
        self.w(f"// kokkos.fused replay: {chain} "
               "(scratch scalar intermediates)", indent)
        out_id = region.outputs[0].id
        t = 0
        for sub in region.ops:
            expr = self.scalar_expr(sub.opname, sub.attrs,
                                    [local[o.id] for o in sub.operands])
            if sub.results[0].id == out_id:
                self.w(f"{out_access} = {expr};", indent)
                local[sub.results[0].id] = out_access
            else:
                t += 1
                self.w(f"const {ctype} t{t} = {expr};", indent)
                local[sub.results[0].id] = f"t{t}"

    def map_body(self, op: Op, idx: str, indent: int):
        """The per-element body of a map nest: either a fused-region
        replay or the single recorded source op."""
        res = self.namer.name(op.results[0])
        out = f"{res}({idx})" if idx else res
        ct = _ctype(op.results[0].type.dtype)
        if op.regions:
            self.region_lines(op, idx, out, ct, indent)
            return
        src = op.attrs.get("src", op.opname)
        exprs = [self.elem(o, idx) for o in op.operands]
        self.w(f"{out} = {self.scalar_expr(src, op.attrs, exprs)};", indent)

    # -- parallel nests -----------------------------------------------------

    def emit_range_parallel(self, op: Op):
        """1-D map → ``Kokkos::parallel_for(RangePolicy)``."""
        res = self.namer.name(op.results[0])
        if not op.results[0].type.shape:
            raise TranslateError(
                "rank-0 (scalar) parallel nests have no C++ spelling "
                "(nothing to iterate); keep scalars as literals")
        n = op.results[0].type.shape[0]
        label = self.kernel_label(op, res)
        self.alloc(op.results[0])
        if op.attrs.get("collapse"):
            self.w("// collapsed nest (library backend): the vendor library "
                   "owns the mapping")
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"Kokkos::RangePolicy<lapis_exec>(0, {n}),")
        self.w("    KOKKOS_LAMBDA(const int i0) {")
        self.map_body(op, "i0", 2)
        self.w("});")

    def emit_collapsed_map(self, op: Op):
        """Collapsed multi-dim map on a library backend → one flat
        ``MDRangePolicy`` launch (the library would fuse it anyway)."""
        res = self.namer.name(op.results[0])
        shape = op.results[0].type.shape
        rank = len(shape)
        label = self.kernel_label(op, res)
        self.alloc(op.results[0])
        idx = ", ".join(f"i{d}" for d in range(rank))
        lo = ", ".join("0" for _ in shape)
        hi = ", ".join(str(d) for d in shape)
        args = ", ".join(f"const int i{d}" for d in range(rank))
        self.w("// collapsed nest (library backend): the vendor library owns "
               "the mapping — flat MDRange")
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"Kokkos::MDRangePolicy<lapis_exec, Kokkos::Rank<{rank}>>("
               f"{{{lo}}}, {{{hi}}}),")
        self.w(f"    KOKKOS_LAMBDA({args}) {{")
        self.map_body(op, idx, 2)
        self.w("});")

    def emit_team_map(self, op: Op):
        """Mapped ≥2-D nest → TeamPolicy league over row blocks with
        TeamThreadRange (rows) × ThreadVectorRange (lanes) — the declared
        LoopLevel nest, spelled per §4.2."""
        res = self.namer.name(op.results[0])
        shape = op.results[0].type.shape
        rank = len(shape)
        if rank > 3:
            raise TranslateError(
                f"team map nests over rank-{rank} spaces are not spelled "
                "yet (flatten leading dims first)")
        tiling = op.attrs.get("tiling") or {}
        block = tiling.get("block", shape)
        rows, lanes = shape[-2], shape[-1]
        brows = min(block[-2] if len(block) >= 2 else rows, rows)
        rbc = -(-rows // brows)                      # row blocks
        lead = shape[0] if rank == 3 else 1
        league = lead * rbc
        label = self.kernel_label(op, res)
        self.alloc(op.results[0])
        nest = op.attrs.get("nest", ())
        lm = op.attrs.get("level_map", ())
        self.w(f"// nest ({_fmt_attr(tuple(nest))[1:-1]}) -> level_map "
               f"{_fmt_attr(tuple(lm))}; block rows={brows}")
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({league}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        if rank == 3:
            self.w(f"const int i0 = team.league_rank() / {rbc};", 3)
            self.w(f"const int row0 = (team.league_rank() % {rbc}) * "
                   f"{brows};", 3)
            row_var, idx = "i1", "i0, i1, i2"
        else:
            self.w(f"const int row0 = team.league_rank() * {brows};", 3)
            row_var, idx = "i0", "i0, i1"
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, "
               f"{brows}), [&](const int r) {{", 3)
        self.w(f"const int {row_var} = row0 + r;", 4)
        self.w(f"if ({row_var} >= {rows}) return;", 4)
        inner = "i2" if rank == 3 else "i1"
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, "
               f"{lanes}), [&](const int {inner}) {{", 4)
        self.map_body(op, idx, 5)
        self.w("});", 4)
        self.w("});", 3)
        self.w("});", 2)
        self.w("}")

    def emit_softmax(self, op: Op):
        """Last-axis softmax (the only lowered reduction): one team per
        row, three team-level phases (max, sum, normalize)."""
        res = self.namer.name(op.results[0])
        shape = op.results[0].type.shape
        if len(shape) != 2:
            raise TranslateError(
                f"softmax nests are spelled for rank-2 spaces only, got "
                f"shape {shape}")
        rows, cols = shape
        a = self.namer.name(op.operands[0])
        label = self.kernel_label(op, res)
        self.alloc(op.results[0])
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({rows}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        self.w("const int i0 = team.league_rank();", 3)
        self.w("float row_max = -INFINITY;", 3)
        self.w(f"Kokkos::parallel_reduce(Kokkos::TeamThreadRange(team, "
               f"{cols}),", 3)
        self.w(f"    [&](const int i1, float& m) "
               f"{{ m = fmaxf(m, {a}(i0, i1)); }},", 3)
        self.w("    Kokkos::Max<float>(row_max));", 3)
        self.w("float row_sum = 0.0f;", 3)
        self.w(f"Kokkos::parallel_reduce(Kokkos::TeamThreadRange(team, "
               f"{cols}),", 3)
        self.w(f"    [&](const int i1, float& s) "
               f"{{ s += expf({a}(i0, i1) - row_max); }},", 3)
        self.w("    row_sum);", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, "
               f"{cols}),", 3)
        self.w(f"    [&](const int i1) {{ {res}(i0, i1) = "
               f"expf({a}(i0, i1) - row_max) / row_sum; }});", 3)
        self.w("});", 2)
        self.w("}")

    # -- library calls as generated nests -----------------------------------

    def emit_gemm(self, op: Op):
        res = self.namer.name(op.results[0])
        a, b = (self.namer.name(o) for o in op.operands)
        m, k = op.operands[0].type.shape
        n = op.operands[1].type.shape[1]
        t = op.attrs.get("tiling") or {}
        bm = min(int(t.get("bm", 8)), m) or m
        self.alloc(op.results[0])
        self._team_rows_open(op, res, m, bm, row_var="i")
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, {n}), "
               "[&](const int j) {", 4)
        self.w("float acc = 0.0f;", 5)
        self.w(f"for (int kk = 0; kk < {k}; ++kk) "
               f"acc += {a}(i, kk) * {b}(kk, j);", 5)
        self.w(f"{res}(i, j) = acc;", 5)
        self.w("});", 4)
        self._team_rows_close()

    def emit_gemv(self, op: Op):
        res = self.namer.name(op.results[0])
        a, x = (self.namer.name(o) for o in op.operands)
        m, k = op.operands[0].type.shape
        t = op.attrs.get("tiling") or {}
        bm = min(int(t.get("bm", 8)), m) or m
        self.alloc(op.results[0])
        self._team_rows_open(op, res, m, bm, row_var="i")
        self.w("float acc = 0.0f;", 4)
        self.w(f"Kokkos::parallel_reduce(Kokkos::ThreadVectorRange(team, "
               f"{k}),", 4)
        self.w(f"    [&](const int kk, float& s) "
               f"{{ s += {a}(i, kk) * {x}(kk); }}, acc);", 4)
        self.w(f"{res}(i) = acc;", 4)
        self._team_rows_close()

    # -- sparse ops ---------------------------------------------------------

    def emit_sparse_pack(self, op: Op):
        self.needs_sparse = True
        res = self.namer.name(op.results[0])
        ip, ind, val = (self.namer.name(o) for o in op.operands)
        n_rows, n_cols = op.results[0].type.shape
        self.w(f"const LapisCsr {res}{{{ip}, {ind}, {val}, "
               f"{n_rows}, {n_cols}}};")

    def emit_sparse_convert(self, op: Op):
        self.needs_sparse = True
        res = self.namer.name(op.results[0])
        src = self.namer.name(op.operands[0])
        n_rows, n_cols = op.results[0].type.shape
        width = _ell_width(op.attrs["max_nnz_row"])
        label = self.kernel_label(op, res)
        self.w(f"// CSR -> padded ELL (width {width} = 8-aligned "
               f"max_nnz_row {op.attrs['max_nnz_row']})")
        self.w(f"LapisView2<float> {res}_values(\"{res}_values\", "
               f"{n_rows}, {width});")
        self.w(f"LapisView2<int32_t> {res}_colidx(\"{res}_colidx\", "
               f"{n_rows}, {width});")
        self.w(f"LapisView2<bool> {res}_valid(\"{res}_valid\", "
               f"{n_rows}, {width});")
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"Kokkos::RangePolicy<lapis_exec>(0, {n_rows}),")
        self.w("    KOKKOS_LAMBDA(const int row) {")
        self.w(f"const int32_t p0 = {src}.rowptr(row);", 2)
        self.w(f"const int32_t len = {src}.rowptr(row + 1) - p0;", 2)
        self.w(f"for (int kk = 0; kk < {width}; ++kk) {{", 2)
        self.w("const bool ok = kk < len;", 3)
        self.w(f"{res}_valid(row, kk) = ok;", 3)
        self.w(f"{res}_values(row, kk) = ok ? {src}.values(p0 + kk) : "
               "0.0f;", 3)
        self.w(f"{res}_colidx(row, kk) = ok ? {src}.colidx(p0 + kk) : 0;",
               3)
        self.w("}", 2)
        self.w("});")
        self.w(f"const LapisEll {res}{{{res}_values, {res}_colidx, "
               f"{res}_valid, {n_rows}, {n_cols}}};")

    def _team_rows_open(self, op: Op, res: str, n_rows: int, rb: int,
                        row_var: str = "row") -> None:
        """Open the shared TeamPolicy-over-row-blocks scaffold (league =
        ceil(rows/block), TeamThreadRange rows-in-block + tail guard);
        gemm/gemv/spmv/spmm bodies all live inside it."""
        rbc = -(-n_rows // rb)
        label = self.kernel_label(op, res)
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({rbc}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        self.w(f"const int row0 = team.league_rank() * {rb};", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, {rb}), "
               "[&](const int r) {", 3)
        self.w(f"const int {row_var} = row0 + r;", 4)
        self.w(f"if ({row_var} >= {n_rows}) return;", 4)

    def _team_rows_close(self) -> None:
        self.w("});", 3)
        self.w("});", 2)
        self.w("}")

    def emit_spmv(self, op: Op):
        self.needs_sparse = True
        res = self.namer.name(op.results[0])
        a, x = (self.namer.name(o) for o in op.operands)
        enc = op.operands[0].type.encoding
        n_rows = op.results[0].type.shape[0]
        t = op.attrs.get("tiling") or {}
        rb = min(int(t.get("row_block", 256)), n_rows) or n_rows
        self.alloc(op.results[0])
        self.w(f"// §4.2 row loop ({enc.format.upper()}): team over "
               f"{rb}-row blocks, vector over row entries")
        self._team_rows_open(op, res, n_rows, rb)
        self.w("float acc = 0.0f;", 4)
        if enc.format == "ell":
            width = _ell_width(enc.max_nnz_row)
            self.w(f"Kokkos::parallel_reduce(Kokkos::ThreadVectorRange("
                   f"team, {width}),", 4)
            self.w(f"    [&](const int kk, float& s) {{", 4)
            self.w(f"if ({a}.valid(row, kk)) "
                   f"s += {a}.values(row, kk) * {x}({a}.colidx(row, kk));",
                   6)
            self.w("}, acc);", 4)
        else:
            self.w(f"const int32_t p0 = {a}.rowptr(row);", 4)
            self.w(f"const int32_t p1 = {a}.rowptr(row + 1);", 4)
            self.w("Kokkos::parallel_reduce(Kokkos::ThreadVectorRange("
                   "team, p1 - p0),", 4)
            self.w(f"    [&](const int p, float& s) "
                   f"{{ s += {a}.values(p0 + p) * {x}({a}.colidx(p0 + p)); "
                   f"}}, acc);", 4)
        self.w(f"{res}(row) = acc;", 4)
        self._team_rows_close()

    def emit_spmm(self, op: Op):
        self.needs_sparse = True
        res = self.namer.name(op.results[0])
        a, b = (self.namer.name(o) for o in op.operands)
        enc = op.operands[0].type.encoding
        n_rows, n_out = op.results[0].type.shape
        t = op.attrs.get("tiling") or {}
        rb = min(int(t.get("row_block", 256)), n_rows) or n_rows
        self.alloc(op.results[0])
        self.w(f"// §4.2 row loop ({enc.format.upper()}): team over "
               f"{rb}-row blocks, vector over dense columns")
        self._team_rows_open(op, res, n_rows, rb)
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, "
               f"{n_out}), [&](const int j) {{", 4)
        self.w("float acc = 0.0f;", 5)
        if enc.format == "ell":
            width = _ell_width(enc.max_nnz_row)
            self.w(f"for (int kk = 0; kk < {width}; ++kk)", 5)
            self.w(f"  if ({a}.valid(row, kk)) "
                   f"acc += {a}.values(row, kk) * {b}({a}.colidx(row, kk), "
                   f"j);", 5)
        else:
            self.w(f"for (int32_t p = {a}.rowptr(row); "
                   f"p < {a}.rowptr(row + 1); ++p)", 5)
            self.w(f"  acc += {a}.values(p) * {b}({a}.colidx(p), j);", 5)
        self.w(f"{res}(row, j) = acc;", 5)
        self.w("});", 4)
        self._team_rows_close()

    # -- paged KV cache (the serving engine's compiled data movement) -------

    def emit_page_gather(self, op: Op):
        """``kokkos.page_gather``: league over (slot, block) pairs, team
        over the block's (head, position) entries, vector over the head
        dim — each team copies one page-table block into the slot's
        contiguous view."""
        res = self.namer.name(op.results[0])
        pool, table = (self.namer.name(o) for o in op.operands[:2])
        n_blocks, heads, bs, hd = op.operands[0].type.shape
        n_slots, mb = op.operands[1].type.shape
        label = self.kernel_label(op, res)
        self.alloc(op.results[0])
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({n_slots * mb}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        self.w(f"const int s = team.league_rank() / {mb};", 3)
        self.w(f"const int b = team.league_rank() % {mb};", 3)
        self.w(f"const int32_t blk = {table}(s, b);", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, "
               f"{heads * bs}), [&](const int t) {{", 3)
        self.w(f"const int h = t / {bs};", 4)
        self.w(f"const int p = t % {bs};", 4)
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, "
               f"{hd}), [&](const int d) {{", 4)
        self.w(f"{res}(s, h, b * {bs} + p, d) = {pool}(blk, h, p, d);", 5)
        self.w("});", 4)
        self.w("});", 3)
        self.w("});", 2)
        self.w("}")

    def emit_page_append(self, op: Op):
        """``kokkos.page_append``: league over slots; each team writes one
        token's KV into the slot's tail block at offset
        ``lengths(s) % block_size``.  The result aliases the pool operand
        (Kokkos views have reference semantics — the in-place update the
        functional IR models with a fresh SSA value)."""
        pool, table, lengths, kv = (self.namer.name(o) for o in op.operands)
        res = self.namer.name(op.results[0])
        n_blocks, heads, bs, hd = op.operands[0].type.shape
        n_slots, _ = op.operands[1].type.shape
        label = self.kernel_label(op, res)
        self.w(f"auto {res} = {pool};  // in-place append: views alias")
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({n_slots}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        self.w("const int s = team.league_rank();", 3)
        self.w(f"const int32_t blk = {table}(s, {lengths}(s) / {bs});", 3)
        self.w(f"const int32_t off = {lengths}(s) % {bs};", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, "
               f"{heads}), [&](const int h) {{", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, "
               f"{hd}), [&](const int d) {{", 4)
        self.w(f"{res}(blk, h, off, d) = {kv}(s, h, d);", 5)
        self.w("});", 4)
        self.w("});", 3)
        self.w("});", 2)
        self.w("}")

    def emit_page_copy(self, op: Op):
        """``kokkos.page_copy``: block-granular bulk copy between arenas
        (CoW fork / swap tier, per the ``direction`` attr) — league over
        the copied blocks, team over (head, position), vector over the
        head dim.  The result aliases the destination arena."""
        dst, src, src_ids, dst_ids = (self.namer.name(o)
                                      for o in op.operands)
        res = self.namer.name(op.results[0])
        shape = op.operands[0].type.shape
        if len(shape) != 4:
            raise TranslateError(
                f"kokkos.page_copy over rank-{len(shape)} arenas has no "
                "C++ spelling yet (translate one layer at a time)")
        n_blocks, heads, bs, hd = shape
        n_copies = op.operands[2].type.shape[0]
        direction = op.attrs.get("direction", "copy")
        label = self.kernel_label(op, res)
        self.w(f"auto {res} = {dst};  // in-place block copy "
               f"(direction={direction}): views alias")
        self.w("{")
        self.w("using team_policy = Kokkos::TeamPolicy<lapis_exec>;", 2)
        self.w(f"Kokkos::parallel_for(\"{label}\", "
               f"team_policy({n_copies}, Kokkos::AUTO),", 2)
        self.w("    KOKKOS_LAMBDA(const team_policy::member_type& team) {",
               2)
        self.w("const int c = team.league_rank();", 3)
        self.w(f"const int32_t sb = {src_ids}(c);", 3)
        self.w(f"const int32_t db = {dst_ids}(c);", 3)
        self.w(f"Kokkos::parallel_for(Kokkos::TeamThreadRange(team, "
               f"{heads * bs}), [&](const int t) {{", 3)
        self.w(f"const int h = t / {bs};", 4)
        self.w(f"const int p = t % {bs};", 4)
        self.w(f"Kokkos::parallel_for(Kokkos::ThreadVectorRange(team, "
               f"{hd}), [&](const int d) {{", 4)
        self.w(f"{res}(db, h, p, d) = {src}(sb, h, p, d);", 5)
        self.w("});", 4)
        self.w("});", 3)
        self.w("});", 2)
        self.w("}")

    # -- constants + memory model -------------------------------------------

    def emit_constant(self, op: Op):
        value = _host_array(op.attrs["value"])
        result = op.results[0]
        ct = _ctype(result.type.dtype)
        if value.ndim == 0:
            # paper §4.4: scalar constants inline as literals
            self.namer.bind(result, _lit(value.item(), ct))
            return
        label = constant_label(len(self.weights))
        self.weights.append((label, value, result.type.dtype))
        self.dual_of[result.id] = label
        self.namer.bind(result, label)
        dims = "x".join(str(d) for d in value.shape)
        self.w(f"const auto {label} = lapis_{label}.d_view;  "
               f"// tensor.constant {dims} {result.type.dtype} (DUAL "
               "weight, synced below)")

    def emit_sync(self, op: Op):
        operand = op.operands[0]
        label = self.dual_of.get(operand.id)
        space = op.attrs.get("space", "device")
        if label is None:
            self.w(f"lapis_exec().fence();  // kokkos.sync "
                   f"%{self.namer.name(operand)} {{{space}}} (no DualView "
                   "at this value — coherence is a fence)")
            return
        if space == "host_roundtrip":
            self.w(f"lapis_{label}.sync_host();    // kokkos.sync "
                   "{host_roundtrip} (eager baseline-MLIR mode)")
            self.w(f"lapis_{label}.sync_device();")
            return
        self.w(f"lapis_{label}.sync_device();  // kokkos.sync %{label} "
               f"{{{space}}} — lazy h2d on first use")

    def emit_modify(self, op: Op):
        operand = op.operands[0]
        label = self.dual_of.get(operand.id)
        if label is not None:
            self.w(f"lapis_{label}.modify_device();  // kokkos.modify")

    # -- the walk -----------------------------------------------------------

    def emit_op(self, op: Op):
        name = op.opname
        if name == "tensor.constant":
            self.emit_constant(op)
            return
        for r in op.results:
            self.namer.bind_fresh(r)
        if name not in ("kokkos.sync", "kokkos.modify"):
            self.w(_op_comment(op, self.namer))
        if name == "kokkos.sync":
            self.emit_sync(op)
        elif name == "kokkos.modify":
            self.emit_modify(op)
        elif name == "sparse.pack":
            self.emit_sparse_pack(op)
        elif name == "sparse.convert":
            self.emit_sparse_convert(op)
        elif name == "kk.gemm":
            self.emit_gemm(op)
        elif name == "kk.gemv":
            self.emit_gemv(op)
        elif name == "kk.spmv":
            self.emit_spmv(op)
        elif name == "kk.spmm":
            self.emit_spmm(op)
        elif name == "kokkos.page_gather":
            self.emit_page_gather(op)
        elif name == "kokkos.page_append":
            self.emit_page_append(op)
        elif name == "kokkos.page_copy":
            self.emit_page_copy(op)
        elif name in ("kokkos.range_parallel", "kokkos.team_parallel"):
            rank = len(op.results[0].type.shape)
            if op.attrs.get("kind") == "reduce":
                if op.attrs.get("src") != "linalg.softmax":
                    raise TranslateError(
                        f"no C++ spelling for reduce nest "
                        f"{op.attrs.get('src')!r}")
                self.emit_softmax(op)
            elif rank <= 1:
                self.emit_range_parallel(op)
            elif op.attrs.get("collapse"):
                self.emit_collapsed_map(op)
            else:
                self.emit_team_map(op)
        elif name == "kokkos.fused":
            # un-lowered fused region (kept at tensor level): only a
            # uniform-shape body can be spelled as one flat nest
            shapes = {o.type.shape for o in op.operands}
            if len(shapes) != 1:
                raise TranslateError(
                    "kokkos.fused with mixed operand shapes has no C++ "
                    f"spelling (shapes={sorted(shapes)})")
            self.emit_collapsed_map(op)
        else:
            raise TranslateError(
                f"lapis-translate has no Kokkos C++ spelling for {name} "
                "(structured IR required — closures and unlowered ops "
                "stop here)")
        self.w()

    # -- unit assembly ------------------------------------------------------

    def signature(self) -> tuple:
        """(return type, entry signature line) for the graph."""
        if len(self.graph.outputs) != 1:
            raise TranslateError(
                f"multi-output graphs are not spelled yet "
                f"({len(self.graph.outputs)} outputs)")
        out = self.graph.outputs[0]
        ret = _view(len(out.type.shape), _ctype(out.type.dtype))
        args = ", ".join(
            f"{_view(len(v.type.shape), _ctype(v.type.dtype))} "
            f"{self.namer.name(v)}"
            for v in self.graph.inputs)
        return ret, f"{ret} {self.graph.name}({args})"

    def weight_decls(self) -> list:
        lines = []
        for label, value, dtype in self.weights:
            ct = _ctype(dtype)
            flat = value.ravel(order="C")
            lines.append(f"// {label}: {'x'.join(map(str, value.shape))} "
                         f"{dtype} ({flat.size} elements)")
            lines.append(f"static const {ct} lapis_{label}_data"
                         f"[{flat.size}] = {{")
            row: list = []
            width = 0
            for x in flat:
                lit = _lit(x, ct) + ","
                if width + len(lit) + 1 > 76 and row:
                    lines.append("  " + " ".join(row))
                    row, width = [], 0
                row.append(lit)
                width += len(lit) + 1
            if row:
                lines.append("  " + " ".join(row))
            lines.append("};")
            rank = value.ndim
            lines.append(f"static LapisDual{rank}<{ct}> lapis_{label};")
            lines.append("")
        return lines

    def init_fns(self) -> list:
        lines = ["// paper §4.4: lapis_initialize allocates the globally",
                 "// scoped weight Views and populates their host mirrors;",
                 "// the kokkos.sync ops in the entry function trigger the",
                 "// lazy h2d copies (LAPIS::DualView).  Idempotent: a",
                 "// ctypes-loaded unit calls it on every lapis_run entry,",
                 "// and re-entry must not re-allocate the global Views.",
                 "void lapis_initialize() {",
                 "  static bool lapis_initialized = false;",
                 "  if (lapis_initialized) return;",
                 "  lapis_initialized = true;"]
        for label, value, dtype in self.weights:
            ct = _ctype(dtype)
            dims = ", ".join(str(d) for d in value.shape)
            lines.append(f"  lapis_{label} = LapisDual{value.ndim}<{ct}>("
                         f"\"{label}\", {dims});")
            lines.append(f"  std::memcpy(lapis_{label}.h_view.data(), "
                         f"lapis_{label}_data, sizeof(lapis_{label}_data));")
            lines.append(f"  lapis_{label}.modify_host();")
        lines.append("}")
        lines.append("")
        lines.append("void lapis_finalize() {")
        for label, *_ in self.weights:
            lines.append(f"  lapis_{label} = {{}};")
        lines.append("}")
        return lines

    def cabi_fns(self) -> list:
        """The C-ABI harness: shape/arity/dtype descriptor functions plus
        ``lapis_run``, the uniform pointer-table entry the ctypes loader
        (repro_torch.core.native) drives.  ``ins``/``outs`` are tables of dense
        row-major buffers, each reinterpreted per the dtype descriptor."""
        ins = list(self.graph.inputs)
        out = self.graph.outputs[0]
        out_shape = out.type.shape
        out_ct = _ctype(out.type.dtype)
        lines = [
            "// " + "-" * 74,
            # the reference's wording, kept byte for byte (the host
            # backends' units are pinned to its goldens)
            "// C-ABI entry point: the native differential harness "
            "(repro.core.native)",
            "// loads the compiled unit with ctypes and drives lapis_run "
            "with the same",
            "// inputs the jax callable sees.  Buffer pointers are "
            "reinterpreted per the",
            "// dtype descriptor (0=float32 1=int32 2=int64 3=bool), "
            "dense row-major.",
            "// " + "-" * 74,
            f'extern "C" int lapis_num_inputs() {{ return {len(ins)}; }}',
            'extern "C" int lapis_num_outputs() { return 1; }',
        ]
        if ins:
            ranks = ", ".join(str(len(v.type.shape)) for v in ins)
            lines += [
                'extern "C" int lapis_input_rank(int i) {',
                f"  static const int r[{len(ins)}] = {{{ranks}}};",
                "  return r[i];",
                "}",
            ]
            rows = []
            for v in ins:
                dims = list(v.type.shape) + \
                    [0] * (CABI_MAX_RANK - len(v.type.shape))
                rows.append("{" + ", ".join(str(d) for d in dims) + "}")
            lines += [
                'extern "C" long long lapis_input_dim(int i, int d) {',
                f"  static const long long dims[{len(ins)}]"
                f"[{CABI_MAX_RANK}] = {{",
                "    " + ", ".join(rows) + "};",
                "  return dims[i][d];",
                "}",
                'extern "C" int lapis_input_dtype(int i) {',
                f"  static const int t[{len(ins)}] = "
                "{" + ", ".join(str(_dtype_code(_ctype(v.type.dtype)))
                                for v in ins) + "};",
                "  return t[i];",
                "}",
            ]
        else:
            lines += [
                'extern "C" int lapis_input_rank(int) { return -1; }',
                'extern "C" long long lapis_input_dim(int, int) '
                "{ return 0; }",
                'extern "C" int lapis_input_dtype(int) { return -1; }',
            ]
        out_dims = ", ".join(str(d) for d in out_shape)
        lines += [
            f'extern "C" int lapis_output_rank() '
            f"{{ return {len(out_shape)}; }}",
            'extern "C" long long lapis_output_dim(int d) {',
            f"  static const long long dims[{len(out_shape)}] = "
            f"{{{out_dims}}};",
            "  return dims[d];",
            "}",
            f'extern "C" int lapis_output_dtype() '
            f"{{ return {_dtype_code(out_ct)}; }}",
            "",
            "// idempotent process setup: safe to call once per "
            "lapis_run entry",
            'extern "C" void lapis_setup() {',
            "  if (!Kokkos::is_initialized()) Kokkos::initialize();",
            "  lapis_initialize();",
            "}",
            "",
            'extern "C" void lapis_run(const float** ins, float** outs) {',
            "  lapis_setup();",
        ]
        arg_names = []
        for k, v in enumerate(ins):
            name = self.namer.name(v)
            arg_names.append(name)
            ct = _ctype(v.type.dtype)
            shape = v.type.shape
            dims = ", ".join(str(d) for d in shape)
            lines.append(f"  {_view(len(shape), ct)} {name}("
                         f"\"{name}\", {dims});")
            lines.append("  {")
            lines.append(f"    const {ct}* src{k} = "
                         f"reinterpret_cast<const {ct}*>(ins[{k}]);")
            for d, extent in enumerate(shape):
                pad = "    " + "  " * d
                lines.append(f"{pad}for (int i{d} = 0; i{d} < {extent}; "
                             f"++i{d})")
            pad = "    " + "  " * len(shape)
            idx = ", ".join(f"i{d}" for d in range(len(shape)))
            lines.append(f"{pad}{name}({idx}) = "
                         f"src{k}[{_flat_index(shape)}];")
            lines.append("  }")
        lines.append(f"  const auto lapis_out = {self.graph.name}("
                     f"{', '.join(arg_names)});")
        lines.append("  const auto lapis_host = Kokkos::create_mirror_"
                     "view_and_copy(Kokkos::HostSpace(), lapis_out);")
        lines.append(f"  {out_ct}* dst = "
                     f"reinterpret_cast<{out_ct}*>(outs[0]);")
        for d, extent in enumerate(out_shape):
            pad = "  " + "  " * d
            lines.append(f"{pad}for (int i{d} = 0; i{d} < {extent}; ++i{d})")
        pad = "  " + "  " * len(out_shape)
        idx = ", ".join(f"i{d}" for d in range(len(out_shape)))
        lines.append(f"{pad}dst[{_flat_index(out_shape)}] = "
                     f"static_cast<{out_ct}>(lapis_host({idx}));")
        lines.append("}")
        return lines

    def main_fn(self) -> list:
        out = self.graph.outputs[0]
        shape = out.type.shape
        lines = ["int main(int argc, char** argv) {",
                 "  Kokkos::initialize(argc, argv);",
                 "  {",
                 "    lapis_initialize();"]
        args = []
        for v in self.graph.inputs:
            name = self.namer.name(v)
            ct = _ctype(v.type.dtype)
            dims = ", ".join(str(d) for d in v.type.shape)
            lines.append(f"    {_view(len(v.type.shape), ct)} {name}("
                         f"\"{name}\", {dims});  // zero-filled placeholder")
            args.append(name)
        lines.append(f"    const auto out = {self.graph.name}("
                     f"{', '.join(args)});")
        lines.append("    const auto host = Kokkos::create_mirror_view_"
                     "and_copy(Kokkos::HostSpace(), out);")
        lines.append("    double checksum = 0.0;")
        idx = ", ".join(f"i{d}" for d in range(len(shape)))
        for d, extent in enumerate(shape):
            pad = "    " + "  " * d
            lines.append(f"{pad}for (int i{d} = 0; i{d} < {extent}; ++i{d})")
        pad = "    " + "  " * len(shape)
        lines.append(f"{pad}checksum += static_cast<double>(host({idx}));")
        lines.append(f'    std::printf("{self.graph.name} checksum: '
                     '%g\\n", checksum);')
        lines.append("    lapis_finalize();")
        lines.append("  }")
        lines.append("  Kokkos::finalize();")
        lines.append("  return 0;")
        lines.append("}")
        return lines

    def emit(self) -> str:
        # kernel bodies accumulate and call math in f32 (acc floats,
        # expf/fmaxf, the lapis_* helpers) — emitting f64 views around
        # them would silently truncate, so refuse instead of diverging
        # from the compiled callable
        for v in self.graph.values():
            if _ctype(v.type.dtype) == "double":
                raise TranslateError(
                    "float64 graphs have no C++ spelling yet: emitted "
                    "kernels compute in float (f32); cast the model or "
                    "extend the scalar vocabulary to double")
            if 0 in v.type.shape:
                # static loop bounds of 0 would divide the row-block math
                # — degenerate graphs execute fine but have no kernels
                # worth printing
                raise TranslateError(
                    f"zero-extent tensor {v.type} has no C++ spelling "
                    "(nothing to launch); drop the empty dimension")
        self.namer.bind_inputs(self.graph)
        for op in self.graph.ops:
            self.emit_op(op)
        ret, sig = self.signature()
        out_name = self.namer.name(self.graph.outputs[0])

        tgt = self.target
        head = [
            "// " + "=" * 74,
            f"// Auto-generated by repro lapis-translate — do not edit.",
            f"// module: {self.graph.name}   backend: {self.backend.name} "
            f"  exec space: {tgt.exec_space}",
            "// Self-contained: depends only on Kokkos.  Model weights are "
            "embedded",
            "// below as constant arrays (paper §4.4) and loaded by "
            "lapis_initialize().",
            "// " + "=" * 74,
        ]
        # diagnostics from the between-pass analysis ride into the unit
        # as comments (present only when a verifying compile attached
        # them — golden modules compiled without verify stay byte-stable)
        for d in getattr(self.graph, "diagnostics", ()):
            head.append(f"// analysis: {d.format()}")
        head += [
            "#include <cmath>",
            "#include <cstdint>",
            "#include <cstdio>",
            "#include <cstring>",
            "",
            "#include <Kokkos_Core.hpp>",
            "#include <Kokkos_DualView.hpp>",
            "",
            f"using lapis_exec = {tgt.exec_space};",
            f"using lapis_layout = {tgt.layout};",
            "using lapis_device = Kokkos::Device<lapis_exec, "
            "typename lapis_exec::memory_space>;",
        ]
        ranks_used = {len(v.type.shape)
                      for v in self.graph.values() if v.type.shape}
        ranks_used |= {w[1].ndim for w in self.weights} | {1, 2}
        for r in sorted(ranks_used):
            stars = "*" * r
            head.append(f"template <typename T> using LapisView{r} = "
                        f"Kokkos::View<T{stars}, lapis_layout, "
                        "lapis_device>;")
        for r in sorted({w[1].ndim for w in self.weights}):
            stars = "*" * r
            head.append(f"template <typename T> using LapisDual{r} = "
                        f"Kokkos::DualView<T{stars}, lapis_layout, "
                        "lapis_device>;")
        head.append("")
        if self.helpers:
            head.append("// scalar math vocabulary of the elementwise "
                        "dialect")
            for name in sorted(self.helpers):
                head.append(_HELPERS[name])
            head.append("")
        if self.needs_sparse:
            head.append(_SPARSE_STRUCTS)
            head.append("")

        parts = head + self.weight_decls() + self.init_fns() + [""]
        parts.append("// entry point (the paper's kokkosModule.forward)")
        parts.append(sig + " {")
        parts.extend(self.body)
        parts.append(f"  return {out_name};")
        parts.append("}")
        parts.append("")
        parts.extend(self.cabi_fns())
        parts.append("")
        parts.extend(self.main_fn())
        parts.append("")
        return "\n".join(parts)


def emit_cpp_source(graph: Graph,
                    options: Optional[CompileOptions] = None) -> str:
    """Emit a freestanding Kokkos C++ translation unit implementing the
    lowered ``graph`` (the lapis-translate stage, paper §4.4)."""
    options = options or current_options()
    return _CppEmitter(graph, options).emit()
