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
from repro_torch.kernels import paged_kv as pk
from repro_torch.kernels import spmm as spmm_mod
from repro_torch.kernels import spmv as spmv_mod

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


# ---------------------------------------------------------------------------
# slice 2: SpMV, SpMM, the paged gather, and their demos
# ---------------------------------------------------------------------------

def _csr_on_card(rng, n_rows, n_cols, lengths):
    """A CSR matrix with the given row lengths (trailing zeros leave the
    last rows empty), uniform columns, on the card."""
    lens = np.asarray(lengths, np.int64)
    indptr = np.zeros(n_rows + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    nnz = int(indptr[-1])
    return spmv_mod.CsrMatrix(
        torch.from_numpy(indptr).cuda(),
        torch.from_numpy(rng.integers(0, n_cols, nnz).astype(np.int32))
        .cuda(), _randn(rng, (nnz,)), n_rows, n_cols)


_SPARSE_CASES = {
    "random": lambda r: _csr_on_card(r, 1000, 700, r.poisson(9, 1000)),
    "trailing-empty": lambda r: _csr_on_card(
        r, 300, 64, np.r_[r.poisson(5, 250), np.zeros(50, int)]),
    "dense-row": lambda r: _csr_on_card(
        r, 64, 512, np.r_[[512], r.integers(0, 3, 63)]),
    "nnz-zero": lambda r: _csr_on_card(r, 17, 9, np.zeros(17, int)),
}
_TILINGS = [None, {"row_block": 1, "row_width": 1},
            {"row_block": 8, "row_width": 24},
            {"row_block": 256, "row_width": 32},
            {"row_block": 1000, "row_width": 8}]


@pytest.mark.parametrize("tiling", _TILINGS)
@pytest.mark.parametrize("case", sorted(_SPARSE_CASES))
def test_spmv_and_spmm_kernels_match_plain(card, rng, case, tiling):
    a = _SPARSE_CASES[case](rng)
    x = _randn(rng, (a.n_cols,))
    b = _randn(rng, (a.n_cols, 16))
    before = (spmv_mod.spmv.launches, spmm_mod.spmm_sparse.launches)
    y = spmv_mod.spmv(a, x, tiling=tiling)
    yb = spmm_mod.spmm_sparse(a, b, tiling=tiling)
    torch.cuda.synchronize()
    assert (spmv_mod.spmv.launches, spmm_mod.spmm_sparse.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, spmv_mod.spmv_reference(a, x),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yb, spmv_mod.spmm_reference(a, b),
                               rtol=1e-5, atol=1e-5)


def test_sparse_kernels_refuse_ell_on_the_card(card, rng):
    a = _SPARSE_CASES["random"](rng)
    ell = spmv_mod.as_ell(a)
    with pytest.raises(TypeError):
        spmv_mod.spmv(ell, _randn(rng, (a.n_cols,)))
    with pytest.raises(TypeError):
        spmm_mod.spmm_sparse(ell, _randn(rng, (a.n_cols, 4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("geom", [(17, 2, 8, 16, 4, 4), (9, 1, 5, 3, 3, 2),
                                  (65, 2, 16, 128, 8, 8)])
def test_page_gather_kernel_is_an_exact_copy(card, rng, geom, dtype):
    nb, h, bs, hd, s, mb = geom
    pool = torch.from_numpy(rng.integers(-100, 100, (nb, h, bs, hd))
                            .astype(np.float32)).to("cuda", dtype)
    table = torch.from_numpy(rng.integers(0, nb, (s, mb)).astype(np.int32)
                             ).cuda()
    lengths = torch.zeros(s, dtype=torch.int32, device="cuda")
    got = pk.page_gather(pool, table, lengths, block_size=bs)
    want = pk.page_gather_torch(pool, table, lengths, block_size=bs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


def test_page_gather_kernel_zeroes_ids_outside_the_pool(card):
    pool = torch.ones((3, 1, 4, 4), device="cuda")
    table = torch.tensor([[0, 3], [-1, 2]], dtype=torch.int32, device="cuda")
    got = pk.page_gather(pool, table, torch.zeros(2, dtype=torch.int32,
                                                  device="cuda"),
                         block_size=4)
    assert got[0, 0, :4].eq(1).all() and got[0, 0, 4:].eq(0).all()
    assert got[1, 0, :4].eq(0).all() and got[1, 0, 4:].eq(1).all()


@pytest.mark.parametrize("demo", ["spmv", "paged", "paged_swap"])
def test_slice2_demos_run_through_the_kernels_only(card, demo):
    wrappers = {"spmv": spmv_mod.spmv, "spmm": spmm_mod.spmm_sparse,
                "page_gather": pk.page_gather, "matmul": mm.matmul,
                "block_map_region": generic.block_map_region,
                "row_softmax": generic.row_softmax}
    for w in wrappers.values():
        w.launches = w.plain_calls = 0
    fn, specs, ex = pipeline._DEMOS[demo]()
    mod = pipeline.compile(fn, *specs, options=CompileOptions(target="cuda"))
    y = mod(*ex)
    torch.cuda.synchronize()
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    assert launched == {"spmv": {"spmv": 1, "block_map_region": 1},
                        "paged": {"page_gather": 1},
                        "paged_swap": {}}[demo]
    assert all(w.plain_calls == 0 for w in wrappers.values())
    lib = pipeline.compile(fn, *specs, options=CompileOptions(target="torch"))
    torch.testing.assert_close(y, lib(*ex), rtol=1e-5, atol=1e-5)
