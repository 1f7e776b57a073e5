"""The port's kernel plumbing that the CPU can check without JAX: the
region code generator (its functor compiled as host C++ with g++ and held
to the plain torch region), the tilings the H100 hierarchy hands the
matmul kernel, and the no-fallback rules (a ``cuda`` request without a
card raises; a wrapper given non-CPU tensors never takes its plain
version)."""
import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ops, pipeline
from repro_torch.core.backend import H100_HIERARCHY
from repro_torch.core.options import CompileOptions
from repro_torch.core.passes import choose_matmul_blocks
from repro_torch.core.refs import region_ref
from repro_torch.core.tracer import TensorSpec
from repro_torch.kernels import codegen, generic
from repro_torch.kernels import matmul as mm
from repro_torch.kernels._build import CSRC

SHAPE = (16, 48)


def _chain(a, b, c):
    h = ops.gelu(ops.maximum(ops.tanh(a) * ops.sigmoid(b),
                             ops.exp(ops.neg(a)) - c))
    h = ops.sqrt(ops.relu(h) + ops.rsqrt(ops.exp(c)))
    return ops.silu(ops.power(h, 2.0) / (ops.exp(b) + c))


def _silu_mul(g, u):
    return ops.silu(g) * u


def _add_relu(a, b):
    return ops.relu(a + b)


def _nest(fn, n_args):
    """The single fused nest ``fn`` lowers to, and the positions of its
    operands among the graph's inputs (a region's block arguments mirror
    the nest's operands, repeats included)."""
    spec = TensorSpec(SHAPE, "float32")
    mod = pipeline.compile(fn, *([spec] * n_args),
                           options=CompileOptions(target="cuda",
                                                  device="cpu"))
    nests = [op for op in mod.graph.ops
             if op.opname == "kokkos.team_parallel" and op.regions]
    assert len(nests) == 1, mod.print_ir()
    pos = [[v.id for v in mod.graph.inputs].index(o.id)
           for o in nests[0].operands]
    return nests[0].regions[0], pos


def _region(fn, n_args):
    return _nest(fn, n_args)[0]


_HOST_MAIN = """
#include "lapis_scalar.h"
{functor}
extern "C" void run(const float* const* ins, float* out, long n) {{
  for (long i = 0; i < n; ++i) {{
    float x[LapisRegion::kInputs];
    for (int j = 0; j < LapisRegion::kInputs; ++j) x[j] = ins[j][i];
    out[i] = LapisRegion{{}}(x);
  }}
}}
"""


@pytest.mark.parametrize("fn,n_args", [(_chain, 3), (_silu_mul, 2),
                                       (_add_relu, 2)],
                         ids=["every-op", "silu-mul", "add-relu"])
def test_generated_functor_matches_plain_region(fn, n_args, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the generated functor as host code")
    region, pos = _nest(fn, n_args)
    src = tmp_path / "region.cpp"
    src.write_text(_HOST_MAIN.format(functor=codegen.functor_source(region)))
    lib = tmp_path / "region.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(src)], check=True, timeout=120)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                    ctypes.c_long]
    rng = np.random.default_rng(0)
    args = [np.ascontiguousarray(rng.uniform(0.1, 2.0, SHAPE)
                                 .astype(np.float32))
            for _ in range(n_args)]
    operands = [args[i] for i in pos]
    out = np.zeros(SHAPE, np.float32)
    ptrs = (ctypes.c_void_p * len(operands))(
        *[a.ctypes.data for a in operands])
    run(ptrs, out.ctypes.data, out.size)
    want = region_ref(region)(*[torch.from_numpy(a)
                                for a in operands]).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_kernel_source_types_loads_and_launcher():
    """The generated unit types each operand's raw vector loads, runs the
    functor on every element of K vectors after all their loads, and
    launches the flat skeleton with 16 bytes of the widest type a vector
    (4 elements where an f32 operand or output takes part, 8 where all
    are bf16) and the operands' element sizes, which set K."""
    region = _region(_silu_mul, 2)
    src = codegen.kernel_source(region, ["float32", "bfloat16"], "float32")
    assert '#include "block_map.cuh"' in src
    assert "const float* in0;" in src and "const __nv_bfloat16* in1;" in src
    assert "lapis_silu(x[0])" in src and "(v1 * x[1])" in src
    assert "lapis_map::Vec<W, float> a0[K];" in src
    assert "lapis_map::Vec<W, __nv_bfloat16> a1[K];" in src
    assert "a0[k].load(in0, v + k * stride);" in src
    assert "a1[k].load(in1, v + k * stride);" in src
    assert "const float x[2] = {a0[k][e], a1[k][e]};" in src
    assert "lapis_map::store<W>(out, v + k * stride, y);" in src
    assert src.index("a1[k].load(in1") < src.index("LapisRegion{}(x)")
    assert 'extern "C" int lapis_region_launch(void* const* ptrs, ' \
        'long long n, void* stream)' in src
    # 4 elements a vector (f32 is the widest); the operands' sizes sum to 6
    assert "lapis_map::launch<LapisBody, 4, 6>(body, ptrs, 3, n, stream);" \
        in src
    bf16 = codegen.kernel_source(region, ["bfloat16"] * 2, "bfloat16")
    assert "lapis_map::launch<LapisBody, 8, 4>(body, ptrs, 3, n, stream);" \
        in bf16
    assert "LapisTile" not in src
    with pytest.raises(TypeError):
        codegen.kernel_source(region, ["int32", "float32"], "float32")


def test_unfused_power_nest_spells_its_exponent(tmp_path):
    """An unfused power's nest carries its exponent, so its generated
    kernel spells ``powf(x, 3.0f)``; the IR dump does not show it (the
    reference's nest has no such attr), and the functor, compiled as
    host C++, matches ``x ** 3``."""
    spec = TensorSpec(SHAPE, "float32")
    mod = pipeline.compile(lambda a: ops.power(a, 3.0), spec,
                           options=CompileOptions(target="loops",
                                                  device="cpu"))
    (nest,) = [op for op in mod.graph.ops
               if op.opname == "kokkos.team_parallel"]
    assert "exponent" not in mod.print_ir()
    region = generic.one_op_region(nest)
    assert "powf(x[0], 3.0f)" in codegen.functor_source(region)
    src = codegen.kernel_source(region, ["float32"], "float32")
    assert "powf(x[0], 3.0f)" in src
    gxx = shutil.which("g++")
    if gxx is None:
        return
    host = tmp_path / "power.cpp"
    host.write_text(_HOST_MAIN.format(
        functor=codegen.functor_source(region)))
    lib = tmp_path / "power.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(host)], check=True, timeout=120)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                    ctypes.c_long]
    x = np.random.default_rng(0).uniform(-2, 2, SHAPE).astype(np.float32)
    out = np.zeros(SHAPE, np.float32)
    run((ctypes.c_void_p * 1)(x.ctypes.data), out.ctypes.data, out.size)
    np.testing.assert_allclose(out, x.astype(np.float64) ** 3, rtol=1e-5,
                               atol=1e-6)


def test_unfused_nest_without_a_spelling_raises():
    """``linalg.map`` (a named Python function) has no C++ spelling: its
    nest raises instead of launching a kernel that computes something
    else."""
    from repro_torch.core.ir import Op, TensorType, Value
    t = TensorType(SHAPE, "float32")
    nest = Op("kokkos.team_parallel", [Value(t)], [t],
              attrs={"kind": "map", "src": "linalg.map", "fn": abs})
    with pytest.raises(NotImplementedError, match="linalg.map"):
        generic.one_op_region(nest)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_h100_hierarchy_only_yields_tilings_the_kernel_runs(itemsize):
    extents = (1, 7, 8, 10, 65, 127, 129, 1000, 1536, 2048, 8960)
    for m, n, k in itertools.product(extents, repeat=3):
        t = choose_matmul_blocks(m, n, k, itemsize, H100_HIERARCHY)
        mm.check_tiling(t)


def test_block_shapes_get_the_documented_tiling():
    for m, n, k in ((2048, 8960, 1536), (2048, 1536, 8960)):
        assert choose_matmul_blocks(m, n, k, 4, H100_HIERARCHY) == \
            {"bm": 64, "bn": 128, "bk": 64}


@pytest.mark.parametrize("tiling", [{"bm": 12, "bn": 128, "bk": 64},
                                    {"bm": 512, "bn": 512, "bk": 64},
                                    {"bm": 64, "bn": 128, "bk": 512}])
def test_matmul_refuses_tilings_it_cannot_run(tiling):
    with pytest.raises(ValueError):
        mm.check_tiling(tiling)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CompileOptions(target="cuda").resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pipeline.compile(_add_relu, TensorSpec(SHAPE, "float32"),
                         TensorSpec(SHAPE, "float32"),
                         options=CompileOptions(target="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pipeline.main(["--demo", "mlp", "--target", "cuda"])
    with pytest.raises(ValueError):
        CompileOptions(device="tpu").resolve_device()


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only CPU tensors reach a plain version; any other device (here
    ``meta``, standing in for a card) must launch the kernel or raise."""
    a = torch.empty((8, 8), device="meta")
    region = _region(_add_relu, 2)
    before = (mm.matmul.plain_calls, generic.block_map_region.plain_calls,
              generic.row_softmax.plain_calls)
    with pytest.raises(ValueError):
        mm.matmul(a, a)
    with pytest.raises(ValueError):
        generic.block_map_region(region, [a, a], (8, 8), "float32",
                                 block=(8, 8))
    with pytest.raises(ValueError):
        generic.row_softmax(a)
    with pytest.raises(ValueError):
        mm.matmul(torch.zeros(8, 8), a)     # mixed devices
    assert before == (mm.matmul.plain_calls,
                      generic.block_map_region.plain_calls,
                      generic.row_softmax.plain_calls)


def test_library_registrations_cover_the_kernels():
    from repro_torch.core import backend
    cuda = backend.get_backend("cuda")
    assert {"kk.gemm", "kk.gemv"} <= set(cuda.registered_ops())
    assert backend.get_backend("torch").kernel("kk.gemm") is not None


def test_kernel_module_imports_need_no_compiler():
    assert Path(CSRC / "matmul.cu").exists()
    assert (CSRC / "block_map.cuh").exists() and \
        (CSRC / "row_softmax.cu").exists()
