"""The port's hand kernels on the card, held to their plain torch
versions on the same inputs.  Every test here carries the ``cuda`` marker
and skips where torch sees no card; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the machine with the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ops, pipeline
from repro_torch.core.options import CompileOptions
from repro_torch.core.refs import region_ref, softmax
from repro_torch.core.tracer import TensorSpec
from repro_torch.kernels import generic, ops as kops
from repro_torch.kernels import matmul as mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _randn(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to("cuda", dtype)


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 70, 250), (256, 512, 128),
                                   (33, 129, 65), (1, 1, 1), (127, 65, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(card, rng, m, k, n, dtype):
    a = _randn(rng, (m, k), dtype=dtype)
    b = _randn(rng, (k, n), k ** -0.5, dtype=dtype)
    before = (mm.matmul.launches, mm.matmul.plain_calls)
    got = mm.matmul(a, b)
    torch.cuda.synchronize()
    assert (mm.matmul.launches, mm.matmul.plain_calls) == \
        (before[0] + 1, before[1])
    want = torch.matmul(a.float(), b.float())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_gemv_kernel_matches_plain(card, rng):
    a, x = _randn(rng, (1000, 777)), _randn(rng, (777,), 777 ** -0.5)
    torch.testing.assert_close(kops.gemv_cuda(a, x), a @ x, rtol=1e-5,
                               atol=1e-5)


def _chain(a, b, c):
    h = ops.gelu(ops.maximum(ops.tanh(a) * ops.sigmoid(b),
                             ops.exp(ops.neg(a)) - c))
    h = ops.sqrt(ops.relu(h) + ops.rsqrt(ops.exp(c)))
    return ops.silu(ops.power(h, 2.0) / (ops.exp(b) + c))


@pytest.mark.parametrize("shape", [(7,), (33, 130), (3, 5, 1100)])
def test_generated_region_kernel_matches_plain(card, rng, shape):
    spec = TensorSpec(shape, "float32")
    mod = pipeline.compile(_chain, spec, spec, spec,
                           options=CompileOptions(target="cuda"))
    (nest,) = [op for op in mod.graph.ops if op.regions]
    args = [torch.from_numpy(rng.uniform(0.1, 2.0, shape)
                             .astype(np.float32)).cuda() for _ in range(3)]
    before = generic.block_map_region.launches
    got = mod(*args)
    torch.cuda.synchronize()
    assert generic.block_map_region.launches == before + 1
    assert mod.launch_count == 1
    operands = [args[[v.id for v in mod.graph.inputs].index(o.id)]
                for o in nest.operands]
    torch.testing.assert_close(got, region_ref(nest.regions[0])(*operands),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,cols", [(8, 10), (300, 1024), (5, 33)])
def test_row_softmax_kernel_matches_plain(card, rng, rows, cols):
    x = _randn(rng, (rows, cols), 4.0)
    got = generic.row_softmax(x)
    torch.testing.assert_close(got, softmax(x, -1), rtol=1e-5, atol=1e-6)


def test_mlp_demo_runs_through_the_kernels_only(card):
    for w in (mm.matmul, generic.block_map_region, generic.row_softmax):
        w.launches = w.plain_calls = 0
    fn, specs, (ex,) = pipeline._demo_mlp()
    mod = pipeline.compile(fn, *specs, options=CompileOptions(target="cuda"))
    y = mod(ex)
    torch.cuda.synchronize()
    assert abs(float(y.sum()) - 8.0) < 1e-4
    assert mod.launch_count == 4
    assert (mm.matmul.launches, generic.block_map_region.launches,
            generic.row_softmax.launches) == (2, 1, 1)
    assert mm.matmul.plain_calls == generic.block_map_region.plain_calls \
        == generic.row_softmax.plain_calls == 0
    lib = pipeline.compile(fn, *specs, options=CompileOptions(target="torch"))
    torch.testing.assert_close(y, lib(ex), rtol=1e-5, atol=1e-5)


def test_cpu_input_to_a_card_module_raises(card):
    fn, specs, _ = pipeline._demo_mlp()
    mod = pipeline.compile(fn, *specs, options=CompileOptions(target="cuda"))
    with pytest.raises(ValueError):
        mod(torch.zeros(8, 64))
