"""Region → CUDA C++: the code generator behind the mapped-nest kernels.

A ``kokkos.fused`` region is IR data — an ordered list of ``linalg.*``
elementwise sub-op records whose block arguments mirror the owning op's
operands.  :func:`functor_source` spells that list as one C++ functor,
one expression per sub-op, every intermediate a local ``float`` (so it
lives in registers).  :func:`kernel_source` wraps the functor in the
hand-written skeleton of ``csrc/block_map.cuh`` (a flat grid-stride
stream of 16-byte vectors) with a body of typed vector loads and stores
and an ``extern "C"`` launcher.  This mirrors what LAPIS itself
does: emit C++ from the IR (the reference's ``core/translate.py`` spells
the same vocabulary for Kokkos lambdas).

The functor includes only ``csrc/lapis_scalar.h``, so it also compiles as
host C++; the CPU tests use that to hold a generated body against the
plain torch version of the region.
"""
from __future__ import annotations

from typing import Sequence

# {0}, {1} are operand expressions (block-arg loads or earlier locals)
CPP_SCALAR = {
    "linalg.add": "({0} + {1})",
    "linalg.sub": "({0} - {1})",
    "linalg.mul": "({0} * {1})",
    "linalg.div": "({0} / {1})",
    "linalg.maximum": "lapis_maximum({0}, {1})",
    "linalg.relu": "lapis_relu({0})",
    "linalg.gelu": "lapis_gelu({0})",
    "linalg.silu": "lapis_silu({0})",
    "linalg.sigmoid": "lapis_sigmoid({0})",
    "linalg.tanh": "tanhf({0})",
    "linalg.exp": "expf({0})",
    "linalg.neg": "(-{0})",
    "linalg.sqrt": "sqrtf({0})",
    "linalg.rsqrt": "lapis_rsqrt({0})",
}

# every op a generated body can spell: the table above, and the power,
# whose exponent rides in the op's attrs
SPELLED = frozenset(CPP_SCALAR) | {"linalg.power"}

# IR dtype name → the C element type the loads and stores are typed on
C_TYPES = {"float32": "float", "bfloat16": "__nv_bfloat16",
           "float16": "__half"}
ITEMSIZES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _expr(op, args: list) -> str:
    if op.opname in CPP_SCALAR:
        return CPP_SCALAR[op.opname].format(*args)
    if op.opname == "linalg.power":
        return f"powf({args[0]}, {float(op.attrs['exponent'])!r}f)"
    raise NotImplementedError(
        f"no C++ spelling for {op.opname} in a generated region kernel")


def functor_source(region, name: str = "LapisRegion") -> str:
    """The region body as a C++ functor: ``float operator()(const float*
    x)`` reads block argument ``i`` from ``x[i]`` and returns the yielded
    value."""
    names = {v.id: f"x[{i}]" for i, v in enumerate(region.inputs)}
    lines = [f"struct {name} {{",
             f"  static constexpr int kInputs = {len(region.inputs)};",
             "  LAPIS_HD float operator()(const float* x) const {"]
    for n, op in enumerate(region.ops, 1):
        local = f"v{n}"
        args = [names[o.id] for o in op.operands]
        lines.append(f"    const float {local} = {_expr(op, args)};"
                     f"  // {op.opname}")
        names[op.results[0].id] = local
    lines += [f"    return {names[region.outputs[0].id]};", "  }", "};"]
    return "\n".join(lines) + "\n"


def kernel_source(region, in_dtypes: Sequence[str], out_dtype: str) -> str:
    """A complete CUDA translation unit for ``region`` over operands of
    ``in_dtypes`` producing ``out_dtype``: the functor; a body whose
    ``step<W, K>`` loads K raw vectors of W elements of every operand by
    its type (all loads issued before the first value is computed), runs
    the functor on each element in f32 and stores the results; and the
    launcher ``lapis_region_launch(ptrs, n, stream)`` over the n
    elements, whose ``ptrs`` are the operands' data pointers followed by
    the output's.
    The vector is 16 bytes of the widest of the operands and the output
    (``csrc/block_map.cuh``); the library also exports the launch plan,
    ``lapis_map_plan``."""
    n = len(region.inputs)
    if len(in_dtypes) != n:
        raise ValueError(f"region has {n} inputs, got {len(in_dtypes)} "
                         "operand dtypes")
    for dt in (*in_dtypes, out_dtype):
        if dt not in C_TYPES:
            raise TypeError(f"generated region kernels take "
                            f"{sorted(C_TYPES)}, not {dt}")
    vec = 16 // max(ITEMSIZES[dt] for dt in (*in_dtypes, out_dtype))
    in_bytes = sum(ITEMSIZES[dt] for dt in in_dtypes)
    at = "v + k * stride"
    fields = [f"  const {C_TYPES[dt]}* in{i};"
              for i, dt in enumerate(in_dtypes)]
    vectors = [f"    lapis_map::Vec<W, {C_TYPES[dt]}> a{i}[K];"
               for i, dt in enumerate(in_dtypes)]
    loads = [f"      a{i}[k].load(in{i}, {at});" for i in range(n)]
    elems = ", ".join(f"a{i}[k][e]" for i in range(n))
    casts = ", ".join(f"(const {C_TYPES[dt]}*)ptrs[{i}]"
                      for i, dt in enumerate(in_dtypes))
    ops = " -> ".join(op.opname for op in region.ops)
    return "\n".join([
        f"// Generated from a kokkos region: {ops}",
        '#include "block_map.cuh"',
        "",
        functor_source(region),
        "struct LapisBody {",
        *fields,
        f"  {C_TYPES[out_dtype]}* out;",
        "  template <int W, int K>",
        "  __device__ __forceinline__ void step(long long v, long long "
        "stride, long long lim) const {",
        *vectors,
        "#pragma unroll",
        "    for (int k = 0; k < K; ++k) {   // every load first",
        f"      if ({at} >= lim) continue;",
        *loads,
        "    }",
        "#pragma unroll",
        "    for (int k = 0; k < K; ++k) {",
        f"      if ({at} >= lim) continue;",
        "      float y[W];",
        "#pragma unroll",
        "      for (int e = 0; e < W; ++e) {",
        f"        const float x[{n}] = {{{elems}}};",
        "        y[e] = LapisRegion{}(x);",
        "      }",
        f"      lapis_map::store<W>(out, {at}, y);",
        "    }",
        "  }",
        "};",
        "",
        'extern "C" int lapis_region_launch(void* const* ptrs, long long n, '
        "void* stream) {",
        f"  const LapisBody body{{{casts}, "
        f"({C_TYPES[out_dtype]}*)ptrs[{n}]}};",
        f"  return lapis_map::launch<LapisBody, {vec}, {in_bytes}>(body, "
        f"ptrs, {n + 1}, n, stream);",
        "}",
        ""])
