"""The port's hand kernels on the card, held to their plain torch
versions on the same inputs.  Every test here carries the ``cuda`` marker
and skips where torch sees no card; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the machine with the card has none.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import ops, pipeline
from repro_torch.core.options import CompileOptions
from repro_torch.core.refs import region_ref, softmax
from repro_torch.core.tracer import TensorSpec
from repro_torch.kernels import batched_gemm as bg
from repro_torch.kernels import generic, ops as kops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import paged_kv as pk
from repro_torch.kernels import spmm as spmm_mod
from repro_torch.kernels import spmv as spmv_mod
from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rglru as rg_mod
from repro_torch.kernels import rmsnorm as rn_mod
from repro_torch.kernels import rwkv6 as rw_mod

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


def _nest_region(fn, n_args):
    spec = TensorSpec((8, 8), "float32")
    mod = pipeline.compile(fn, *([spec] * n_args),
                           options=CompileOptions(target="cuda"))
    (nest,) = [op for op in mod.graph.ops
               if op.opname == "kokkos.team_parallel"]
    return nest.regions[0] if nest.regions else generic.one_op_region(nest)


def _offset(rng, shape, dtype, offset):
    """A contiguous view ``offset`` elements into a longer buffer: the
    base off the 16-byte vector when offset is 1."""
    n = int(np.prod(shape))
    return _randn(rng, (n + offset,), dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "f32-bf16"])
@pytest.mark.parametrize("shape", [(1,), (7,), (33, 130), (1001,),
                                   (3, 5, 1100), (2048, 1536)])
def test_map_kernel_tails_offsets_and_dtypes(card, rng, shape, dtypes,
                                             offset):
    """silu(g) * u over ragged tails (n mod the vector != 0), a base one
    element off the 16-byte vector (the whole launch at V = 1), bf16, and
    an f32 gate with a bf16 up operand into f32 (the bf16 operand read by
    8-byte loads).  f32 is held to the plain version at 1e-5; bf16 (f32
    inside, one rounding) to the plain version in f32 within 2^-8 of its
    row's largest value."""
    region = _nest_region(lambda g, u: ops.silu(g) * u, 2)
    dt_g, dt_u = {"f32": (torch.float32,) * 2,
                  "bf16": (torch.bfloat16,) * 2,
                  "f32-bf16": (torch.float32, torch.bfloat16)}[dtypes]
    g, u = _offset(rng, shape, dt_g, offset), _offset(rng, shape, dt_u, offset)
    before = generic.block_map_region.launches
    got = generic.block_map_region(region, [g, u], shape, dt_g,
                                   block=(1, 1024))
    torch.cuda.synchronize()
    assert generic.block_map_region.launches == before + 1
    assert got.dtype == dt_g and tuple(got.shape) == shape
    want = region_ref(region)(g.float(), u.float())
    if dt_g == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        row = want.abs().amax(-1, keepdim=True)
        assert bool(((got.float() - want).abs() <= 2.0 ** -8 * row).all())


def test_map_kernel_block_does_not_steer_the_launch(card, rng):
    """Two tilings of the same nest: the same launch, bitwise the same
    output."""
    region = _nest_region(lambda a, b: a + b, 2)
    a, b = _randn(rng, (2048, 1536)), _randn(rng, (2048, 1536))
    y1 = generic.block_map_region(region, [a, b], (2048, 1536), "float32",
                                  block=(1, 1024))
    y2 = generic.block_map_region(region, [a, b], (2048, 1536), "float32",
                                  block=(64, 128))
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1, a + b, rtol=0, atol=0)


def test_map_plan_is_the_launchers(card):
    """lapis_map_plan, built into every generated library, is the Python
    twin's plan (kernels/generic.py::map_plan)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = generic.region_library(_nest_region(lambda a, b: a + b, 2),
                                 [torch.float32] * 2, torch.float32)
    for n, its, al in itertools.product(
            (0, 1, 3, 7, 8, 1001, 4097, 2048 * 1536, 2048 * 8960, 10 ** 9),
            ((4, 4, 4), (2, 2, 2), (4, 2, 4)), (True, False)):
        assert generic.c_map_plan(lib, n, its, al, sms) == \
            generic.map_plan(n, its, al, sms), (n, its, al)


def test_map_sass_has_16_byte_loads_and_no_spills(card):
    """Every generated region kernel (f32, bf16, a three-operand chain)
    loads by 16 bytes and touches no local memory."""
    import re

    from repro_torch.kernels import _build
    cases = ((lambda g, u: ops.silu(g) * u, 2, "float32"),
             (lambda g, u: ops.silu(g) * u, 2, "bfloat16"),
             (_chain, 3, "float32"))
    for fn, n_args, dt in cases:
        region = _nest_region(fn, n_args)
        ks = generic.region_kernel(region, [dt] * len(region.inputs), dt)
        parts = re.split(r"Function : (\S+)", _build.sass(ks))
        assert len(parts) == 3, parts[1::2]
        body = parts[2]
        assert "LDG.E.128" in body, (dt, len(region.inputs))
        assert not re.search(r"\b(?:LDL|STL)\b", body), \
            (dt, len(region.inputs))


# (8, 10): the mlp demo (general path); (8, 1000): ResNet18's head (a
# block a row); (4096, 1024): a warp a row at the pass's widest; (4, 4096):
# wider than the pass admits (general path, values re-read)
@pytest.mark.parametrize("rows,cols", [(8, 10), (300, 1024), (5, 33),
                                       (8, 1000), (4096, 1024), (4, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_softmax_kernel_matches_plain(card, rng, rows, cols, dtype):
    x = _randn(rng, (rows, cols), 4.0, dtype=dtype)
    before = generic.row_softmax.launches
    got = generic.row_softmax(x)
    torch.cuda.synchronize()
    assert generic.row_softmax.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, softmax(x, -1), rtol=1e-5, atol=1e-6)
    else:
        # bf16: the kernel computes in f32 and rounds once, so it is the
        # plain version in f32 rounded to bf16, to an ulp (2^-8 relative)
        torch.testing.assert_close(got.float(), softmax(x.float(), -1),
                                   rtol=2 ** -8, atol=1e-6)


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
    # rows of 0, 1 and 345 entries (audikw_1's longest) among short ones
    "lengths-0-1-345": lambda r: _csr_on_card(
        r, 40, 900, np.r_[[0, 1, 345, 0, 1], r.integers(0, 20, 33), [345,
                                                                     1]]),
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
    torch.testing.assert_close(y, _plain_f64(spmv_mod.spmv_reference, a, x),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yb, _plain_f64(spmv_mod.spmm_reference, a, b),
                               rtol=1e-5, atol=1e-5)


def _plain_f64(plain, a, dense):
    """The plain version evaluated in f64 (inputs cast up, the result cast
    to the kernel's dtype): the kernels sum in a fixed order, the plain
    CSR versions by ``index_add_``, whose atomics on the card sum in an
    order that moves from call to call."""
    return plain(a._replace(values=a.values.double()),
                 dense.double()).to(dense.dtype)


def _csr_view(a, offset):
    """The same matrix with its columns and values read from ``offset``
    entries into a longer buffer (row starts off the 16-byte vector)."""
    if not offset:
        return a
    cols = torch.empty(offset + a.indices.numel(), dtype=torch.int32,
                       device="cuda")
    vals = torch.empty(offset + a.values.numel(), dtype=a.values.dtype,
                       device="cuda")
    cols[offset:] = a.indices
    vals[offset:] = a.values
    return a._replace(indices=cols[offset:], values=vals[offset:])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiling", _TILINGS)
@pytest.mark.parametrize("case", ["random", "lengths-0-1-345", "nnz-zero"])
def test_spmv_kernel_in_both_dtypes_and_off_the_vector(card, rng, case,
                                                        tiling, dtype,
                                                        offset):
    """f32 and bf16 (f32 accumulation, one rounding: held to the f32
    product of the same bf16 inputs within 2^-8 of the row's magnitude),
    with the columns and values on the 16-byte vector path or one entry
    off it (the scalar path)."""
    a = _SPARSE_CASES[case](rng)
    a = _csr_view(a._replace(values=a.values.to(dtype)), offset)
    x = _randn(rng, (a.n_cols,), dtype=dtype)
    before = spmv_mod.spmv.launches
    y = spmv_mod.spmv(a, x, tiling=tiling)
    torch.cuda.synchronize()
    assert spmv_mod.spmv.launches == before + 1 and y.dtype == dtype
    a32 = a._replace(values=a.values.float())
    want = spmv_mod.spmv_reference(a32, x.float())
    scale = spmv_mod.spmv_reference(a32._replace(values=a32.values.abs()),
                                    x.float().abs())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert bool(((y.float() - want).abs() <= tol * (scale + 1.0)).all())


def test_spmv_of_an_empty_matrix(card):
    """No rows: nothing launches; rows but no entries: zeros."""
    ip = torch.zeros(1, dtype=torch.int32, device="cuda")
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    a = spmv_mod.CsrMatrix(ip, empty, torch.zeros(0, device="cuda"), 0, 5)
    assert tuple(spmv_mod.spmv(a, torch.ones(5, device="cuda")).shape) == (0,)
    a = spmv_mod.CsrMatrix(torch.zeros(4, dtype=torch.int32, device="cuda"),
                           empty, torch.zeros(0, device="cuda"), 3, 5)
    y = spmv_mod.spmv(a, torch.ones(5, device="cuda"))
    assert y.tolist() == [0.0, 0.0, 0.0]


def test_spmv_plan_is_the_launchers(card):
    """lapis_spmv_plan is the Python twin's plan (kernels/spmv.py::
    spmv_plan) for every tiling the checks admit."""
    for rows, rb, rw, al in itertools.product(
            (1, 5, 1000, 1_465_137), (1, 8, 64, 128, 256, 1000, 1466),
            (1, 2, 3, 4, 5, 8, 9, 16, 24, 31, 32), (True, False)):
        assert spmv_mod.c_plan(rows, rb, rw, al) == \
            spmv_mod.spmv_plan(rows, rb, rw, al), (rows, rb, rw, al)


def test_spmv_sass_streams_and_gathers_with_cache_policies(card):
    """Every SpMV kernel streams its columns and values marked evict-first
    in L1 (the spelling cuobjdump prints for them), and the vector kernels
    load the columns by 16 bytes."""
    import re

    from repro_torch.kernels import _build
    parts = re.split(r"Function : (\S+)", _build.sass(spmv_mod.spmv_kernel()))
    fns = {n: b for n, b in zip(parts[1::2], parts[2::2])
           if "lapis_spmv_kernel" in n}
    assert len(fns) == 2 * 6 * 2     # f32/bf16 x 1..32 lanes x vec 4/1
    for n, body in fns.items():
        for spelling in SPMV_POLICY_LOADS:
            assert spelling in body, (n, spelling)
        if "Li4ELi2EE" in n:         # the 16-byte path (V = 4, U = 2)
            assert "LDG.E.EF.128.CONSTANT" in body, n


# how cuobjdump (CUDA 12.8 / 12.9, sm_90a) spells the SpMV kernels'
# streaming loads: ld.global.nc.L1::evict_first is LDG.E.EF...CONSTANT;
# the x gather's L2 evict-last policy rides in the memory descriptor
# (desc[URn]) and has no mnemonic of its own
SPMV_POLICY_LOADS = ("LDG.E.EF.",)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3, 16, 17, 40, 64])
@pytest.mark.parametrize("case", ["lengths-0-1-345", "nnz-zero", "random",
                                  "trailing-empty"])
def test_spmm_kernel_widths_dtypes_and_offsets(card, rng, case, n, dtype,
                                                offset):
    """SpMM at n = 1 ... 64 columns (16-byte vectors where n is a multiple
    of the vector, a lane a column where not), f32 and bf16, the columns
    and values one entry off the vector (the scalar path), empty rows and
    rows of 345 entries, held to the plain version evaluated in f64
    within 1e-5 (f32) or 2^-8 (bf16: f32 accumulation, one rounding) of
    the row's magnitude (sum of |a| |b| over its entries, plus one), the
    bars of the SpMV test above."""
    a = _SPARSE_CASES[case](rng)
    a = _csr_view(a._replace(values=a.values.to(dtype)), offset)
    b = _randn(rng, (a.n_cols, n), dtype=dtype)
    before = spmm_mod.spmm_sparse.launches
    y = spmm_mod.spmm_sparse(a, b, tiling={"row_block": 8, "row_width": 8})
    torch.cuda.synchronize()
    assert spmm_mod.spmm_sparse.launches == before + 1 and y.dtype == dtype
    a64 = a._replace(values=a.values.double())
    want = spmv_mod.spmm_reference(a64, b.double())
    scale = spmv_mod.spmm_reference(a64._replace(values=a64.values.abs()),
                                    b.double().abs())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert bool(((y.double() - want).abs() <= tol * (scale + 1.0)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_kernel_gives_the_same_bits_twice(card, rng, dtype):
    """The groups' sums meet in a fixed shuffle tree: two calls, the same
    bits (rows of 0 to 345 entries, 16 and 17 columns)."""
    a = _SPARSE_CASES["lengths-0-1-345"](rng)
    a = a._replace(values=a.values.to(dtype))
    for n in (16, 17):
        b = _randn(rng, (a.n_cols, n), dtype=dtype)
        y1 = spmm_mod.spmm_sparse(a, b)
        y2 = spmm_mod.spmm_sparse(a, b)
        assert torch.equal(y1, y2)


def test_spmm_plan_is_the_launchers(card):
    """lapis_spmm_plan is the Python twin's plan (kernels/spmm.py::
    spmm_plan)."""
    for rows, n, rb, item, al in itertools.product(
            (1, 5, 1000, 742_793), (1, 2, 3, 4, 8, 16, 17, 40, 64, 128, 129,
                                    256, 300, 1000),
            (1, 3, 8, 256, 1000), (2, 4), (True, False)):
        assert spmm_mod.c_plan(rows, n, rb, item, al) == \
            spmm_mod.spmm_plan(rows, n, rb, item, al), (rows, n, rb, item, al)


def test_spmm_sass_gathers_by_16_bytes_and_streams_evict_first(card):
    """Every SpMM kernel streams its columns and values marked evict-first
    (LDG.E.EF...) and touches no local memory; the vector kernels gather
    B's rows by 16 bytes (LDG.E.128)."""
    import re

    from repro_torch.kernels import _build
    parts = re.split(r"Function : (\S+)", _build.sass(spmm_mod.spmm_kernel()))
    fns = {n: b for n, b in zip(parts[1::2], parts[2::2])
           if "lapis_spmm_kernel" in n}
    assert len(fns) == 2 * 6 * 2     # f32/bf16 x 1..32 lanes x vector/scalar
    for n, body in fns.items():
        assert "LDG.E.EF." in body, n
        assert not re.search(r"\b(?:LDL|STL)\b", body), n
        if "Li1ELi8EE" not in n:     # the vector kernels (V > 1, U = 1)
            assert "LDG.E.128" in body, n


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
                                  (65, 2, 16, 128, 8, 8),
                                  (166, 8, 16, 128, 4, 33)])
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


# ---------------------------------------------------------------------------
# slice 3: RMSNorm, decode attention, flash attention, one serving step
# ---------------------------------------------------------------------------

# f32: the kernel sums in another order than the plain version; bf16: both
# compute in f32 from the same bf16 inputs and round once, so they differ
# by at most an ulp of the bf16 result or two
_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 64), (3, 33, 128), (1, 1, 256),
                                   (8, 1536), (2048, 1536), (7, 100),
                                   (4, 2560), (4, 4096), (1, 7168),
                                   (2048, 4096), (512, 6144), (61, 7168),
                                   (256, 5120), (256, 64, 128)])
def test_rmsnorm_kernel_matches_plain(card, rng, shape, dtype):
    x = _randn(rng, shape, dtype=dtype)
    w = _randn(rng, (shape[-1],), dtype=dtype)
    before = rn_mod.rmsnorm.launches
    got = rn_mod.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn_mod.rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_unaligned_rows(card, rng, dtype):
    """A slice x[:, 1:] of a wider row (the wrapper makes it contiguous:
    the vector path), and a contiguous view whose base is off 16 bytes
    (the general path), each held to the plain version."""
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    w = _randn(rng, (1536,), dtype=dtype)
    wide = _randn(rng, (8, 1537), dtype=dtype)
    flat = _randn(rng, (8 * 1536 + 1,), dtype=dtype)
    off = flat[1:].view(8, 1536)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    for x, aligned, path in ((wide[:, 1:], True, "block"),
                             (off, False, "general")):
        assert rn_mod.rms_plan(8, 1536, dtype, 132,
                               aligned=aligned)["path"] == path
        before = rn_mod.rmsnorm.launches
        got = rn_mod.rmsnorm(x, w)
        torch.cuda.synchronize()
        assert rn_mod.rmsnorm.launches == before + 1
        torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,d", [(8, 1536), (4, 2560), (4, 4096)])
def test_rmsnorm_bf16_error_no_worse_than_plain(card, rng, rows, d):
    """At the three decode steps' shapes, the bf16 kernel's mean |error|
    against an f64 evaluation is no larger than the plain version's (both
    compute in f32 and round once; the sum order differs)."""
    x = _randn(rng, (rows, d), dtype=torch.bfloat16)
    w = _randn(rng, (d,), dtype=torch.bfloat16)
    x64, w64 = x.double(), w.double()
    exact = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-6) * w64
    err_k = float((rn_mod.rmsnorm(x, w).double() - exact).abs().mean())
    err_p = float((ref.rmsnorm(x, w).double() - exact).abs().mean())
    assert err_k <= err_p, (err_k, err_p)


def test_row_plans_are_the_launchers(card):
    """lapis_rmsnorm_plan and lapis_row_softmax_plan are the Python
    twins' plans (kernels/row_reduce.py), on this card's SM count too."""
    from repro_torch.kernels import _build, row_reduce
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = (("lapis_rmsnorm_plan", _build.load(rn_mod.rmsnorm_kernel()),
             rn_mod.rms_plan),
            ("lapis_row_softmax_plan", _build.load(generic.softmax_kernel()),
             generic.softmax_plan))
    for fn, lib, twin in libs:
        for rows, d in itertools.product(
                (0, 1, 4, 8, 100, 1055, 1056, 2048, 70000),
                (1, 10, 33, 64, 100, 130, 512, 1000, 1024, 1536, 2560, 4096,
                 5120, 6144, 7168, 16384, 16392, 40000)):
            for dtype in (torch.float32, torch.bfloat16):
                for al, sm in itertools.product((True, False), (1, 132, sms)):
                    got = row_reduce.c_plan(lib, fn, rows, d, dtype.itemsize,
                                            al, sm)
                    assert got == twin(rows, d, dtype, sm, aligned=al), \
                        (fn, rows, d, dtype, al, sm)


def test_row_reduce_sass_has_16_byte_loads_and_no_spills(card):
    """Every register-path kernel of both libraries loads by LDG.E.128
    (the .CONSTANT read-only form included) and touches no local memory
    (LDL / STL)."""
    import re

    from repro_torch.kernels import _build
    for ks, sym in ((rn_mod.rmsnorm_kernel(), "lapis_rmsnorm_vec"),
                    (generic.softmax_kernel(), "lapis_softmax_vec")):
        parts = re.split(r"Function : (\S+)", _build.sass(ks))
        fns = {n: b for n, b in zip(parts[1::2], parts[2::2]) if sym in n}
        assert len(fns) == 16      # f32 and bf16, 1..8 vectors a thread
        for n, body in fns.items():
            assert "LDG.E.128" in body, n
            assert not re.search(r"\b(?:LDL|STL)\b", body), n


def _decode_case(rng, b, hq, hkv, s, d, dtype, lengths=None):
    q = _randn(rng, (b, hq, d), dtype=dtype)
    k = _randn(rng, (b, hkv, s, d), dtype=dtype)
    v = _randn(rng, (b, hkv, s, d), dtype=dtype)
    if lengths is None:
        lengths = rng.integers(1, s + 1, b)
    return q, k, v, torch.tensor(np.asarray(lengths), dtype=torch.int32,
                                 device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,d,window", [
    (4, 4, 100, 32, None), (8, 2, 128, 32, None), (4, 1, 90, 32, 33),
    (2, 2, 64, 32, 16), (12, 2, 2048, 128, None), (12, 2, 544, 128, 100),
    (4, 2, 37, 16, None), (6, 1, 300, 64, None), (16, 1, 2048, 256, None),
    (16, 1, 300, 256, 64), (12, 1, 100, 256, None), (20, 2, 128, 64, None),
    (9, 1, 70, 192, None), (8, 8, 48, 64, None), (48, 8, 528, 128, None),
    (40, 40, 272, 128, None), (56, 8, 80, 128, None)])
def test_decode_attention_kernel_matches_plain(card, rng, hq, hkv, s, d,
                                               window, dtype):
    q, k, v, lengths = _decode_case(rng, 3, hq, hkv, s, d, dtype)
    before = da_mod.decode_attention.launches
    got = da_mod.decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert da_mod.decode_attention.launches == before + 1
    want = ref.decode_attention(q, k, v, lengths, window=window)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_attention_kernel_ragged_rows_and_the_empty_row(card, rng):
    """qwen2-1.5b's decode shape at 8 slots: lengths 0, 1 and S among
    ragged ones.  The empty row is 0 from the kernel (NaN from the plain
    version, as the reference's softmax over no position)."""
    s = 2048
    lengths = [0, 1, s, 17, 1000, 2047, 513, 64]
    q, k, v, lens = _decode_case(rng, 8, 12, 2, s, 128, torch.float32,
                                 lengths)
    got = da_mod.decode_attention(q, k, v, lens)
    want = ref.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert got[0].eq(0).all() and want[0].isnan().all()
    torch.testing.assert_close(got[1:], want[1:], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_reads_a_stride0_batch(card, rng, dtype):
    """Chunked prefill hands C query rows one gathered cache row,
    broadcast with batch stride 0: read in place, causal per row."""
    c, s = 64, 300
    q = _randn(rng, (c, 12, 128), dtype=dtype)
    k1 = _randn(rng, (1, 2, s, 128), dtype=dtype)
    v1 = _randn(rng, (1, 2, s, 128), dtype=dtype)
    k, v = k1.expand(c, 2, s, 128), v1.expand(c, 2, s, 128)
    assert k.stride(0) == 0
    lens = torch.arange(s - c + 1, s + 1, dtype=torch.int32, device="cuda")
    got = da_mod.decode_attention(q, k, v, lens)
    want = ref.decode_attention(q, k.contiguous(), v.contiguous(), lens)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [30.0, 0.5])
@pytest.mark.parametrize("s,split", [(64, False), (1152, True)])
def test_decode_attention_kernel_caps_the_logits(card, rng, dtype, cap, s,
                                                 split):
    """grok-1's logit cap, cap · tanh(x / cap) of each scaled score x, at
    its decode heads (48 / 8 of 128) against the capped plain version,
    one chunk a row (unsplit) and many (split, with the merge kernel):
    the queries times 10, so the scores spread to ±30 and the cap of 30
    moves them too (the capped and uncapped plain versions differ)."""
    q, k, v, lengths = _decode_case(rng, 2, 48, 8, s, 128, dtype,
                                    [s, s - 37])
    q = (q.float() * 10).to(dtype)
    groups = da_mod.launch_plan(128, 6, da_mod.TILE, dtype)["groups"]
    assert (da_mod.split_plan(2 * 8 * groups, s)[0] > 1) == split
    _decode_check(q, k, v, lengths, dtype, logit_softcap=cap)
    free = ref.decode_attention(q, k, v, lengths)
    capped = ref.decode_attention(q, k, v, lengths, logit_softcap=cap)
    assert float((free.float() - capped.float()).abs().max()) > 0.05


def test_decode_attention_heads_per_block_comes_from_the_source(card):
    """The wrapper's launch plan (query heads a block takes, head groups,
    m16 tiles, warps over D, padded D, ring stages, shared memory) is the
    CUDA launcher's own, for every head dim, the sweep's reps and both
    types."""
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load(da_mod.decode_attention_kernel())
    out = (ctypes.c_int * 7)()
    for dtype in (torch.float32, torch.bfloat16):
        for d in list(range(16, 257, 16)) + [20, 36, 100]:
            for rep in (1, 2, 6, 8, 9, 16, 20, 32, 40, 48, 64, 80):
                for chunk in (64, 128, 2048):
                    assert lib.lapis_decode_attention_plan(
                        d, rep, chunk, int(dtype == torch.bfloat16), out) == 0
                    p = da_mod.launch_plan(d, rep, chunk, dtype)
                    assert list(out) == [
                        p["heads"], p["groups"], p["mt"], p["wd"],
                        p["padded_dim"], p["stages"], p["smem_bytes"]]


def _decode_check(q, k, v, lengths, dtype, **kw):
    """One kernel launch held to the plain version; a row with no valid
    position is 0 from the kernel (NaN from the plain version)."""
    before = (da_mod.decode_attention.launches,
              da_mod.decode_attention.plain_calls)
    got = da_mod.decode_attention(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert (da_mod.decode_attention.launches,
            da_mod.decode_attention.plain_calls) == (before[0] + 1,
                                                     before[1])
    want = ref.decode_attention(q, k.contiguous(), v.contiguous(), lengths,
                                **kw)
    empty = want.isnan().all(-1)
    assert got[empty].eq(0).all()
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float()[~empty], want.float()[~empty],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,d,window", [
    (32, 1, 200, 64, None), (32, 1, 130, 256, None), (9, 1, 100, 80, None),
    (1, 1, 70, 16, None), (16, 1, 333, 256, 100), (6, 1, 1000, 192, None),
    (64, 2, 65, 128, 7), (48, 1, 100, 256, None), (40, 1, 90, 128, None),
    (2, 1, 129, 36, None)])
def test_decode_attention_edges_match_plain(card, rng, hq, hkv, s, d, window,
                                            dtype):
    """rep 1 to 64 (two head groups at rep 48 and D = 256, a padded m16
    tile at rep 40), D from 16 to 256 (36: a row not 16-byte aligned),
    lengths 0, 1, S and above S, S not a multiple of the 64-position tile,
    a window."""
    q, k, v, lens = _decode_case(rng, 5, hq, hkv, s, d, dtype,
                                 [0, 1, s, s + 5, s // 2 + 3])
    _decode_check(q, k, v, lens, dtype, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_reads_rows_not_16_byte_aligned(card, rng, dtype):
    """A cache whose position stride is D + 1 elements (a view of a wider
    one) is staged with element loads inside the same kernel, not copied."""
    b, hkv, s, d = 3, 2, 300, 64
    q = _randn(rng, (b, 12, d), dtype=dtype)
    k = _randn(rng, (b, hkv, s, d + 1), dtype=dtype)[..., :d]
    v = _randn(rng, (b, hkv, s, d + 1), dtype=dtype)[..., :d]
    assert k.stride(2) == d + 1
    lens = torch.tensor([300, 17, 150], dtype=torch.int32, device="cuda")
    _decode_check(q, k, v, lens, dtype)


def test_decode_attention_bf16_error_near_the_plain_versions(card, rng):
    """At both serving shapes the bf16 kernel's mean |error| against an f64
    evaluation is at most twice the plain version's: both round the output
    to bf16 once, the kernel also rounds P to bf16 before P.V."""
    bf = torch.bfloat16
    for b, hq, hkv, s, d, lengths in (
            (8, 12, 2, 2048, 128, [0, 1, 2048, 17, 1000, 2047, 513, 64]),
            (4, 16, 1, 2048, 256, [2048] * 4)):
        q, k, v, lens = _decode_case(rng, b, hq, hkv, s, d, bf, lengths)
        got = da_mod.decode_attention(q, k, v, lens)
        plain = ref.decode_attention(q, k, v, lens)
        rep = hq // hkv
        pos = torch.arange(s, device="cuda")
        logits = torch.einsum("bhgd,bhsd->bhgs",
                              q.double().view(b, hkv, rep, d),
                              k.double()) * d ** -0.5
        logits = logits.masked_fill(~(pos < lens[:, None, None, None]),
                                    float("-inf"))
        exact = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(logits, -1),
                             v.double()).reshape(b, hq, d)
        keep = lens > 0
        err_k = float((got.double() - exact)[keep].abs().mean())
        err_p = float((plain.double() - exact)[keep].abs().mean())
        assert err_k <= 2.0 * err_p, (b, hq, d, err_k, err_p)


def test_decode_attention_sass_has_hmma_and_ldgsts(card):
    """The bf16 kernel issues tensor-core MMAs (HMMA) and both kernels
    stage K and V by cp.async (LDGSTS)."""
    from repro_torch.kernels import _build
    text = _build.sass(da_mod.decode_attention_kernel())
    assert "HMMA" in text and "LDGSTS" in text


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,d,softcap", [
    (4, 4, 64, 64, True, None, 32, None),
    (4, 2, 100, 100, True, None, 32, None),
    (8, 1, 64, 64, True, 17, 32, None),
    (4, 4, 32, 96, False, None, 32, None),
    (6, 2, 65, 65, True, 33, 32, None),
    (2, 2, 48, 48, True, None, 16, 30.0),
    (12, 2, 2048, 2048, True, None, 128, None),
    (12, 2, 300, 300, True, None, 128, 50.0),
    (4, 2, 130, 70, True, None, 64, None),
    (16, 1, 2040, 2040, True, 2048, 256, None),
    (16, 1, 300, 300, True, 100, 256, None),
    (4, 2, 97, 97, True, None, 192, 30.0),
    (4, 2, 200, 200, True, None, 128, None),
    (2, 1, 130, 130, True, None, 256, None),
    (3, 3, 1, 70, True, None, 48, None)])
def test_flash_attention_kernel_matches_plain(card, rng, hq, hkv, sq, skv,
                                              causal, window, d, softcap,
                                              dtype):
    b = 1 if sq >= 2048 else 2
    q = _randn(rng, (b, hq, sq, d), dtype=dtype)
    k = _randn(rng, (b, hkv, skv, d), dtype=dtype)
    v = _randn(rng, (b, hkv, skv, d), dtype=dtype)
    got = _flash_launch(q, k, v, causal=causal, window=window,
                        logit_softcap=softcap)
    want = ref.attention(q, k, v, causal=causal, window=window,
                         logit_softcap=softcap)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,d,softcap", [
    (1, 8, 8, 1500, 1500, False, 64, None),     # whisper's encoder
    (2, 8, 8, 1, 1500, False, 64, None),        # its decode cross-attention
    (2, 8, 8, 37, 1500, False, 64, None),       # its prefill cross-attention
    (1, 48, 8, 512, 512, True, 128, 30.0),      # grok-1's prefill
    (2, 48, 8, 129, 129, True, 128, 30.0)])
def test_flash_attention_kernel_at_the_new_families_shapes(
        card, rng, b, hq, hkv, sq, skv, causal, d, softcap, dtype):
    """The shapes the moe / encdec families give the flash kernels, with
    k / v as the model's transposed (B, S, H, D) views."""
    q = _randn(rng, (b, sq, hq, d), dtype=dtype).transpose(1, 2)
    k = _randn(rng, (b, skv, hkv, d), dtype=dtype).transpose(1, 2)
    v = _randn(rng, (b, skv, hkv, d), dtype=dtype).transpose(1, 2)
    got = _flash_launch(q, k, v, causal=causal, logit_softcap=softcap)
    want = ref.attention(q, k, v, causal=causal, logit_softcap=softcap)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _flash_launch(q, k, v, **kw):
    """One flash_attention call that must launch the kernel of its dtype
    (bf16: the wgmma / TMA kernel; f32: the FFMA kernel), once."""
    f = fa_mod.flash_attention
    before = (f.launches, f.launches_sm90, f.launches_ffma, f.plain_calls)
    got = f(q, k, v, **kw)
    torch.cuda.synchronize()
    sm90 = q.dtype == torch.bfloat16
    assert (f.launches, f.launches_sm90, f.launches_ffma, f.plain_calls) == (
        before[0] + 1, before[1] + sm90, before[2] + (not sm90), before[3])
    return got


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,d", [
    (2, 4, 2, 64, 256, True, None, 96),     # Sq < Skv, causal (top-left)
    (2, 4, 2, 70, 130, True, None, 16),
    (2, 2, 1, 129, 129, True, None, 64),    # a query tail of 1 row
    (2, 2, 2, 1, 200, False, None, 192),    # one query row
    (2, 4, 4, 257, 257, False, None, 64),   # a KV tail of 1 row
    (2, 3, 3, 200, 200, True, 64, 192),
    (1, 2, 2, 10, 0, False, None, 64)])     # no key at all: zeros
def test_flash_attention_sm90_edges_match_plain(card, rng, b, hq, hkv, sq,
                                                skv, causal, window, d):
    q = _randn(rng, (b, hq, sq, d), dtype=torch.bfloat16)
    k = _randn(rng, (b, hkv, skv, d), dtype=torch.bfloat16)
    v = _randn(rng, (b, hkv, skv, d), dtype=torch.bfloat16)
    got = _flash_launch(q, k, v, causal=causal, window=window)
    want = ref.attention(q, k, v, causal=causal, window=window)
    empty = want.isnan()     # rows with no valid key: 0 from the kernel
    assert got[empty].eq(0).all()
    torch.testing.assert_close(got.float()[~empty], want.float()[~empty],
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_sm90_views_go_to_the_kernel(card, rng):
    """Transposed views are read in place (the same bits as contiguous
    copies); a view TMA cannot address (a base 2 bytes off alignment) is
    made contiguous and still launches the bf16 kernel."""
    bf = torch.bfloat16
    q = _randn(rng, (2, 100, 12, 128), dtype=bf).transpose(1, 2)
    k = _randn(rng, (2, 100, 2, 128), dtype=bf).transpose(1, 2)
    v = _randn(rng, (2, 100, 2, 128), dtype=bf).transpose(1, 2)
    assert all(fa_mod.tma_ready(t) for t in (q, k, v))
    got = _flash_launch(q, k, v)
    want = _flash_launch(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    n = 2 * 12 * 100 * 128
    flat = _randn(rng, (n + 1,), dtype=bf)
    q_off = flat[1:].view(2, 12, 100, 128)
    assert not fa_mod.tma_ready(q_off)
    got = _flash_launch(q_off, k, v)
    torch.testing.assert_close(
        got, _flash_launch(q_off.contiguous(), k, v), rtol=0, atol=0)


def test_flash_attention_sm90_plan_is_the_launchers(card):
    """The wrapper's plan (tile sizes, shared memory) is the CUDA
    launcher's own, for every head dim."""
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load(fa_mod.flash_attention_sm90_kernel())
    plan = (ctypes.c_int * 5)()
    for d in range(16, 257, 16):
        lib.lapis_flash_sm90_plan(d, plan)
        p = fa_mod.sm90_plan(d)
        assert list(plan) == [p["block_q"], p["block_kv"], p["stages"],
                              p["padded_dim"], p["smem_bytes"]]


def test_flash_attention_sm90_sass_has_wgmma_and_tma(card):
    """The bf16 library issues warpgroup MMAs (HGMMA) and TMA tile loads
    (UTMALDG): the tensor cores and the copy engine its design names."""
    from repro_torch.kernels import _build
    text = _build.sass(fa_mod.flash_attention_sm90_kernel())
    assert "HGMMA" in text and "UTMALDG" in text


def test_flash_attention_f32_plan_is_the_launchers(card):
    """The f32 kernel's plan (threads, rows, tiles, shared memory, blocks
    an SM by shared memory) is the CUDA launcher's own for every head
    dim, and the card holds two blocks an SM up to D = 128."""
    for d in range(16, 257, 16):
        p = fa_mod.ffma_plan(d)
        assert fa_mod.c_ffma_plan(d) == p, d
        occ = fa_mod.ffma_occupancy(d)
        assert 1 <= occ <= p["blocks_per_sm"], (d, occ)
        if d <= 128:
            assert occ >= 2, (d, occ)


def test_flash_attention_f32_sass_has_ldgsts_and_no_spills(card):
    """Every f32 kernel (D = 16 ... 256) stages Q, K and V by cp.async
    (LDGSTS) and touches no local memory (LDL / STL)."""
    import re

    from repro_torch.kernels import _build
    parts = re.split(r"Function : (\S+)", _build.sass(fa_mod.flash_attention_kernel()))
    fns = {n: b for n, b in zip(parts[1::2], parts[2::2])
           if "lapis_flash_f32_kernel" in n}
    assert len(fns) == 16
    for n, body in fns.items():
        assert "LDGSTS" in body, n
        assert not re.search(r"\b(?:LDL|STL)\b", body), n


def test_flash_attention_f32_copies_misaligned_views(card, rng):
    """A view cp.async cannot read in place (a base 4 bytes off 16-byte
    alignment) is copied first and still launches the f32 kernel, with
    the bits of the contiguous copy."""
    n = 2 * 4 * 70 * 64
    flat = _randn(rng, (n + 1,))
    q = flat[1:].view(2, 4, 70, 64)
    k = _randn(rng, (2, 2, 70, 64))
    v = _randn(rng, (2, 2, 70, 64))
    assert not fa_mod.async_ready(q) and fa_mod.async_ready(k)
    got = _flash_launch(q, k, v)
    torch.testing.assert_close(got, _flash_launch(q.contiguous(), k, v),
                               rtol=0, atol=0)


def _attention_f64(q, k, v, *, causal=True, window=None):
    """The attention of bf16 inputs evaluated in f64, batch by batch."""
    out = []
    rep = q.shape[1] // k.shape[1]
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    for i in range(q.shape[0]):
        kb = k[i].double().repeat_interleave(rep, 0)
        vb = v[i].double().repeat_interleave(rep, 0)
        s = torch.einsum("hqd,hkd->hqk", q[i].double(), kb) * d ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        out.append(torch.einsum("hqk,hkd->hqd", p, vb))
    return torch.stack(out)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 12, 2, 2048, 128, None),       # qwen2-1.5b prefill
    (4, 16, 1, 2040, 256, 2048)])      # recurrentgemma-9b local attention
def test_flash_attention_sm90_error_near_the_plain_versions(card, rng, b, hq,
                                                            hkv, s, d,
                                                            window):
    """At both headline shapes the bf16 kernel's mean |error| against an
    f64 evaluation is at most twice the plain version's: both round the
    output to bf16 once, the kernel also rounds P before P.V."""
    bf = torch.bfloat16
    q = _randn(rng, (b, hq, s, d), dtype=bf)
    k = _randn(rng, (b, hkv, s, d), dtype=bf)
    v = _randn(rng, (b, hkv, s, d), dtype=bf)
    got = _flash_launch(q, k, v, window=window)
    plain = ref.attention(q, k, v, window=window)
    exact = _attention_f64(q, k, v, window=window)
    err_k = float((got.double() - exact).abs().mean())
    err_p = float((plain.double() - exact).abs().mean())
    assert err_k <= 2.0 * err_p, (err_k, err_p)


def test_flash_attention_kernel_reads_transposed_views(card, rng):
    """The model hands (B, S, H, D) projections transposed to (B, H, S, D):
    the kernel reads the strides, the result equals the contiguous one."""
    q = _randn(rng, (2, 100, 12, 128)).transpose(1, 2)
    k = _randn(rng, (2, 100, 2, 128)).transpose(1, 2)
    v = _randn(rng, (2, 100, 2, 128)).transpose(1, 2)
    got = fa_mod.flash_attention(q, k, v)
    want = fa_mod.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_serving_kernels_refuse_what_they_do_not_take(card, rng):
    q, k, v, lens = _decode_case(rng, 2, 4, 2, 64, 320, torch.float32)
    with pytest.raises(ValueError):     # head dim 320
        da_mod.decode_attention(q, k, v, lens)
    q, k, v, lens = _decode_case(rng, 2, 8, 2, 64, 128, torch.float32)
    with pytest.raises(TypeError):
        da_mod.decode_attention(q[:, :4], k, v, lens.long())
    with pytest.raises(ValueError):     # head dim 40
        fa_mod.flash_attention(*(_randn(rng, (1, 2, 8, 40))
                                 for _ in range(3)))
    with pytest.raises(TypeError):
        rn_mod.rmsnorm(_randn(rng, (4, 8)).half(), _randn(rng, (8,)))
    with pytest.raises(TypeError):      # a weight in another dtype than x
        rn_mod.rmsnorm(_randn(rng, (4, 8), dtype=torch.bfloat16),
                       _randn(rng, (8,)))


def test_full_width_paged_decode_step_cuda_matches_torch(card):
    """qwen2-1.5b at its published widths (depth cut to 4 layers, seeded
    weights, bf16): one paged decode step over 8 ragged slots on the
    cuda target against the torch target."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.options import use_options
    from repro_torch.launch.serve import cast_compute
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4)
    model = build_model(cfg)
    params = cast_compute(model.init(0, "cuda"), cfg.compute_dtype)
    bs, slots, mb = 16, 8, 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    lengths = torch.tensor([0, 5, 17, 33, 64, 100, 127, 90],
                           dtype=torch.int32, device="cuda")
    table = (torch.arange(slots * mb, dtype=torch.int32, device="cuda")
             .view(slots, mb) + 1)
    token = torch.randint(1, cfg.vocab_size, (slots,), generator=gen,
                          device="cuda", dtype=torch.int32)
    pools = model.init_paged_cache(slots * mb + 1, bs, device="cuda")
    for k in pools:
        pools[k] = [torch.randn(p.shape, generator=gen, device="cuda")
                    .to(p.dtype) for p in pools[k]]
    out = {}
    for target in ("cuda", "torch"):
        for w in (da_mod.decode_attention, rn_mod.rmsnorm, pk.page_gather):
            w.launches = w.plain_calls = 0
        with use_options(CompileOptions(target=target)):
            logits, _ = model.paged_decode_step(params, token, pools, table,
                                                lengths, block_size=bs)
        torch.cuda.synchronize()
        out[target] = logits.float()
        kernels = (da_mod.decode_attention.launches, rn_mod.rmsnorm.launches,
                   pk.page_gather.launches)
        assert kernels == ((4, 9, 8) if target == "cuda" else (0, 0, 0))
        assert da_mod.decode_attention.plain_calls == 0
    err = float((out["cuda"] - out["torch"]).abs().max())
    assert err <= 0.05 * float(out["torch"].abs().max()), err


def test_recurrentgemma_ring_decode_attention(card, rng):
    """The hybrid's ring decode: 4 rows, 16 query heads over one KV head
    of 256, a 2048-slot ring read with min(length + 1, W) valid slots and
    no window, before and after the wrap."""
    for n_valid in (2041, 2048):
        q, k, v, lens = _decode_case(rng, 4, 16, 1, 2048, 256,
                                     torch.bfloat16, [n_valid] * 4)
        got = da_mod.decode_attention(q, k, v, lens)
        want = ref.decode_attention(q, k, v, lens)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def _scan_tensors(rng, shapes, dtype, w_range=None):
    out = []
    for i, shape in enumerate(shapes):
        if w_range is not None and i == 3:    # the decay w in (lo, hi)
            lo, hi = w_range
            a = lo + (hi - lo) * rng.random(shape)
        else:
            a = rng.standard_normal(shape) * (0.1 if i == 4 else 0.5)
        out.append(torch.from_numpy(a.astype(np.float32)).to("cuda", dtype))
    return out


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,k,v,w_range", [
    (2, 16, 3, 8, 16, (0.5, 0.9)), (2, 37, 3, 8, 16, (0.5, 0.9)),
    (2, 64, 3, 8, 16, (0.5, 0.9)), (3, 9, 2, 100, 48, (0.5, 0.9)),
    (4, 512, 40, 64, 64, (0.97, 0.999)), (1, 70, 2, 128, 256, (0.5, 0.9)),
    (2, 9, 2, 16, 5, (0.5, 0.9)), (2, 130, 3, 64, 64, (0.0, 1e-6)),
    (2, 130, 3, 64, 64, (0.0, 0.0)), (2, 130, 3, 64, 64, (1.0, 1.0)),
    (2, 65, 3, 40, 100, (0.0, 1e-6)), (1, 33, 2, 32, 64, (1.0, 1.0))])
def test_rwkv6_kernel_matches_plain(card, rng, b, t, h, k, v, w_range, dtype,
                                   with_state):
    """The sweep shapes of tests/test_kernels.py, the rwkv6-3b prefill's
    (4 x 512 tokens, 40 heads x 64, decays near 1), the largest state the
    wrapper takes (K 128 x V 256: four slices of 64 columns), V 5 (one
    slice, mostly padding), and extreme decays over several chunks (w in
    [0, 1e-6], w = 0, w = 1; K and V off the 16-byte rows), from zeros or
    a given state, the final state included."""
    r, kk, vv, w, u = _scan_tensors(
        rng, [(b, t, h, k), (b, t, h, k), (b, t, h, v), (b, t, h, k),
              (h, k)], dtype, w_range)
    s0 = (torch.from_numpy(rng.standard_normal((b, h, k, v))
                           .astype(np.float32)).cuda() if with_state
          else None)
    before = (rw_mod.rwkv6_scan.launches, rw_mod.rwkv6_scan.plain_calls)
    y, s = rw_mod.rwkv6_scan(r, kk, vv, w, u, s0)
    torch.cuda.synchronize()
    assert (rw_mod.rwkv6_scan.launches, rw_mod.rwkv6_scan.plain_calls) == \
        (before[0] + 1, before[1])
    want_y, want_s = ref.rwkv6_scan(r, kk, vv, w, u, s0)
    assert y.dtype == dtype and s.dtype == torch.float32
    tol = _TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=2e-4, atol=2e-4)


def test_rwkv6_kernel_gives_the_same_bits_twice(card, rng):
    """The chunks' chain has a fixed order: two calls give the same bits,
    at the prefill's shape in bf16 and over many chunks in f32."""
    for shape, dtype in (((4, 512, 40, 64, 64), torch.bfloat16),
                         ((2, 1000, 3, 64, 64), torch.float32)):
        b, t, h, k, v = shape
        ins = _scan_tensors(rng, [(b, t, h, k), (b, t, h, k), (b, t, h, v),
                                  (b, t, h, k), (h, k)], dtype, (0.97, 0.999))
        s0 = _randn(rng, (b, h, k, v))
        y1, s1 = rw_mod.rwkv6_scan(*ins, s0)
        y2, s2 = rw_mod.rwkv6_scan(*ins, s0)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_rwkv6_plan_is_the_launchers(card):
    """The wrapper's plan (state rows, chunks, slices, tickets, shared
    memory) is the CUDA launcher's own."""
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, k, v in ((4, 512, 40, 64, 64), (1, 1, 2, 5, 7),
                              (2, 0, 3, 16, 16), (3, 33, 2, 100, 48),
                              (1, 70, 2, 128, 256), (2, 17, 3, 8, 16)):
            assert rw_mod.c_plan(b, t, h, k, v, dtype) == \
                rw_mod.wkv_plan(b, t, h, k, v, dtype), (b, t, h, k, v, dtype)


def test_rwkv6_sass_has_ldgsts_and_no_spills(card):
    """Every kernel (f32 and bf16; 16, 32, 64, 128 state rows; chunks of
    1, 2, 4 sub-chunks) copies its inputs by cp.async (LDGSTS), runs its
    products on the tensor cores (HMMA: mma.sync in 3xTF32) and touches no
    local memory (LDL / STL)."""
    import re

    from repro_torch.kernels import _build
    parts = re.split(r"Function : (\S+)", _build.sass(rw_mod.rwkv6_kernel()))
    fns = {n: b for n, b in zip(parts[1::2], parts[2::2])
           if "lapis_rwkv6_kernel" in n}
    assert len(fns) == 2 * 4 * 3
    for n, body in fns.items():
        assert "LDGSTS" in body and "HMMA" in body, n
        assert not re.search(r"\b(?:LDL|STL)\b", body), n


def test_rwkv6_kernel_reads_strided_inputs(card, rng):
    """r, k, v, w sliced out of one wider projection: read in place."""
    wide = _randn(rng, (2, 20, 4 * 3 * 16))
    r, k, v, w = (wide[..., i * 48:(i + 1) * 48].reshape(2, 20, 3, 16)
                  for i in range(4))
    w = torch.sigmoid(w)
    u = _randn(rng, (3, 16), 0.1)
    assert r.stride(1) == 192
    got = rw_mod.rwkv6_scan(r, k, v, w, u)
    want = rw_mod.rwkv6_scan(*(t.contiguous() for t in (r, k, v, w)), u)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [(2, 16, 32), (2, 29, 48), (2, 64, 128),
                                   (4, 2040, 4096), (4, 1, 4096),
                                   (3, 11, 4099), (2, 3, 256), (2, 4, 256),
                                   (2, 5, 256), (2, 127, 4096),
                                   (2, 128, 4096), (2, 129, 4096),
                                   (2, 300, 4099), (1, 2040, 256),
                                   (3, 0, 64)])
def test_rglru_kernel_matches_plain(card, rng, b, t, d, dtype, with_state):
    """The sweep shapes of tests/test_kernels.py, recurrentgemma-9b's
    prefill (4 x 2040 tokens, 4096 channels) and decode step (T = 1 from
    the cached h); T one below, at and above a segment (4 steps) and a
    chunk (128 steps at D = 4096); D = 4099 off the vector over several
    chunks; a long T over few channels (the chain of chunks); T = 0."""
    x, r, i = (_randn(rng, (b, t, d), dtype=dtype) for _ in range(3))
    la = _randn(rng, (d,), dtype=dtype)
    h0 = _randn(rng, (b, d)) if with_state else None
    before = (rg_mod.rglru_scan.launches, rg_mod.rglru_scan.plain_calls)
    y, h = rg_mod.rglru_scan(x, r, i, la, h0)
    torch.cuda.synchronize()
    assert (rg_mod.rglru_scan.launches, rg_mod.rglru_scan.plain_calls) == \
        (before[0] + 1, before[1])
    want_y, want_h = ref.rglru_scan(x, r, i, la, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = _TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_with_decays_near_one(card, rng, dtype):
    """log_a very negative: a_t near 1 (about 0.9995), so h sums many
    small steps over T = 2040 and the end h each chunk hands the next
    carries most of it."""
    b, t, d = 2, 2040, 256
    x, r, i = (_randn(rng, (b, t, d), dtype=dtype) for _ in range(3))
    la = (_randn(rng, (d,), 0.5) - 9.0).to(dtype)
    h0 = _randn(rng, (b, d))
    y, h = rg_mod.rglru_scan(x, r, i, la, h0)
    want_y, want_h = ref.rglru_scan(x, r, i, la, h0)
    tol = _TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_reads_a_base_off_the_vector(card, rng, dtype):
    """x, r, i one element (2 or 4 bytes) into their buffers: the scalar
    path over several chunks."""
    b, t, d = 2, 300, 256
    bufs = [_randn(rng, (b * t * d + 1,), dtype=dtype) for _ in range(3)]
    x, r, i = (u[1:].view(b, t, d) for u in bufs)
    assert x.data_ptr() % 16
    la = _randn(rng, (d,), dtype=dtype)
    h0 = _randn(rng, (b, d))
    y, h = rg_mod.rglru_scan(x, r, i, la, h0)
    want_y, want_h = ref.rglru_scan(x, r, i, la, h0)
    tol = _TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


def test_rglru_kernel_is_deterministic(card, rng):
    """The chunks hand each other their end h in a fixed order: two calls
    give the same bits."""
    x, r, i = (_randn(rng, (4, 2040, 4096), dtype=torch.bfloat16)
               for _ in range(3))
    la = _randn(rng, (4096,), dtype=torch.bfloat16)
    y1, h1 = rg_mod.rglru_scan(x, r, i, la)
    y2, h2 = rg_mod.rglru_scan(x, r, i, la)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_rglru_plan_is_the_launchers(card):
    """lapis_rglru_plan is the Python twin's plan (kernels/rglru.py::
    rglru_plan), on this card's SM count too."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, d in itertools.product((1, 4, 7), (0, 1, 2, 3, 4, 5, 17, 127,
                                                 128, 129, 2040, 4096),
                                     (8, 33, 48, 256, 4096, 4099)):
        for dtype, al, sm in itertools.product(
                (torch.float32, torch.bfloat16), (True, False), (1, 132, sms)):
            assert rg_mod.c_plan(b, t, d, dtype, sm, al) == \
                rg_mod.rglru_plan(b, t, d, dtype, sm, al), (b, t, d, dtype)


def test_rglru_sass_has_16_byte_loads_and_no_spills(card):
    """Every kernel (bf16 and f32; 2 or 4 vectors, or 1-8 scalars, a
    thread) touches no local memory (LDL / STL), and the vector kernels
    copy their x, r and i into the shared-memory ring by 16-byte cp.async
    (LDGSTS.E.BYPASS.128)."""
    import re

    from repro_torch.kernels import _build
    parts = re.split(r"Function : (\S+)", _build.sass(rg_mod.rglru_kernel()))
    fns = {n: b for n, b in zip(parts[1::2], parts[2::2])
           if "lapis_rglru_kernel" in n}
    vec = {n: b for n, b in fns.items()
           if "__nv_bfloat16Li8E" in n or "IfLi4E" in n}
    assert len(fns) == 2 * (2 + 4) and len(vec) == 4
    for n, body in fns.items():
        assert not re.search(r"\b(?:LDL|STL)\b", body), n
    for n, body in vec.items():
        assert "LDGSTS.E.BYPASS.128" in body, n


def test_scan_kernels_refuse_what_they_do_not_take(card, rng):
    x = _randn(rng, (2, 4, 8))
    with pytest.raises(TypeError):      # a bf16 gate beside f32 x
        rg_mod.rglru_scan(x, x.bfloat16(), x, _randn(rng, (8,)))
    with pytest.raises(TypeError):      # an f32 log_a beside bf16 inputs
        rg_mod.rglru_scan(*(x.bfloat16(),) * 3, _randn(rng, (8,)))
    with pytest.raises(ValueError):     # log_a of the wrong width
        rg_mod.rglru_scan(x, x, x, _randn(rng, (9,)))
    r = _randn(rng, (1, 3, 2, 130))
    with pytest.raises(ValueError):     # K = 130 state rows per thread
        rw_mod.rwkv6_scan(r, r, r, r, _randn(rng, (2, 130)))
    r = _randn(rng, (1, 3, 2, 16))
    with pytest.raises(TypeError):      # a bf16 state
        rw_mod.rwkv6_scan(r, r, r, r, _randn(rng, (2, 16)),
                          torch.zeros((1, 2, 16, 16), device="cuda",
                                      dtype=torch.bfloat16))


@pytest.mark.parametrize("arch,layers", [("rwkv6-3b", 2),
                                         ("recurrentgemma-9b", 4)])
def test_recurrent_families_serve_through_the_kernels(card, arch, layers):
    """Both families at their published widths (depth cut; seeded
    weights; f32 compute): the wave loop's greedy tokens on the cuda
    target equal the torch target's, every scan and attention step on
    the card going through the kernels and none through a plain
    version.  The hybrid's 4 layers are one (R, R, A) group and an R
    remainder."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.options import use_options
    from repro_torch.launch.serve import cast_compute, generate
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype="float32")
    model = build_model(cfg)
    params = cast_compute(model.init(0, "cuda"), "float32")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    wrappers = (rw_mod.rwkv6_scan, rg_mod.rglru_scan, rn_mod.rmsnorm,
                fa_mod.flash_attention, da_mod.decode_attention)
    out = {}
    for target in ("cuda", "torch"):
        for w in wrappers:
            w.launches = w.plain_calls = 0
        with use_options(CompileOptions(target=target)):
            out[target] = generate(model, params, prompts, gen_len=6,
                                   max_len=46)
        torch.cuda.synchronize()
        assert all(w.plain_calls == 0 for w in wrappers)
        launched = {w.__name__ for w in wrappers if w.launches}
        if target == "torch":
            assert not launched
        elif arch == "rwkv6-3b":
            assert launched == {"rwkv6_scan", "rmsnorm"}
        else:
            assert launched == {"rglru_scan", "rmsnorm", "flash_attention",
                                "decode_attention"}
    np.testing.assert_array_equal(out["cuda"], out["torch"])


# ---------------------------------------------------------------------------
# batched GEMM (both kernels) and the ResNet18 / MALA paths
# ---------------------------------------------------------------------------

def _bgemm_counts():
    return {w.__name__: (w.launches, w.plain_calls)
            for w in (bg.batched_gemm_small, bg.batched_gemm_tiled)}


def _bgemm_check(a, b, tiling, kernel, out_dtype=None):
    before = _bgemm_counts()
    got = bg.batched_gemm(a, b, tiling=tiling, out_dtype=out_dtype)
    torch.cuda.synchronize()
    after = _bgemm_counts()
    launched = {n for n in after if after[n][0] != before[n][0]}
    assert launched == {kernel}
    assert all(after[n][1] == before[n][1] for n in after)
    want = torch.matmul(a.float(), b.float())
    tol = 2e-4 if a.dtype == torch.float32 else 2e-2
    assert got.dtype == (out_dtype or a.dtype)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,m,k,n", [(256, 32, 32, 32), (256, 16, 16, 16),
                                     (37, 12, 70, 20), (5, 1, 33, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_small_kernel_matches_plain(card, rng, b, m, k, n,
                                                 dtype):
    """The pass's tilings (batch_block 32); a batch tail of 37 = 32 + 5
    and a K of 70 over chunks of 32."""
    a = _randn(rng, (b, m, k), dtype=dtype)
    bb = _randn(rng, (b, k, n), k ** -0.5, dtype=dtype)
    tiling = bg.default_tiling(a.shape, bb.shape, a.element_size())
    assert tiling["vectorize_batch"] and tiling["batch_block"] == min(b, 32)
    _bgemm_check(a, bb, tiling, "batched_gemm_small")


@pytest.mark.parametrize("b,m,k,n", [
    (1, 32, 32, 32), (7, 16, 16, 16), (255, 32, 32, 32), (257, 32, 32, 32),
    (257, 1, 5, 1), (7, 3, 1, 5), (5, 1, 70, 1000), (255, 16, 5, 16),
    (33, 24, 70, 40), (1, 32, 1, 32), (2000, 32, 32, 32), (600, 24, 40, 40),
    (3, 1, 8, 2048), (3, 2000, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_small_kernel_edges_match_plain(card, rng, b, m, k, n,
                                                     dtype):
    """Batch tails 1, 7, 255 and 257; 1 x 1 to 1 x 2048 and 2000 x 1
    outputs; K of 1, 5, 40 and 70 (rows that are and are not 16-byte aligned, one K chunk or
    several); 2000 and 600 matrices (blocks of several rounds)."""
    a = _randn(rng, (b, m, k), dtype=dtype)
    bb = _randn(rng, (b, k, n), k ** -0.5, dtype=dtype)
    tiling = {"bm": 32, "bn": 32, "bk": 32, "batch_block": 32,
              "vectorize_batch": True}
    _bgemm_check(a, bb, tiling, "batched_gemm_small")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_small_kernel_reads_offset_and_broadcast_operands(
        card, rng, dtype):
    """An operand one element off 16-byte alignment (2 bytes in bf16) is
    staged with element loads; B broadcast with batch stride 0; bf16 to an
    f32 output."""
    tiling = {"bm": 32, "bn": 32, "bk": 32, "batch_block": 32,
              "vectorize_batch": True}
    b, m, k, n = 300, 32, 32, 32
    flat = _randn(rng, (b * m * k + 1,), dtype=dtype)
    a = flat[1:].view(b, m, k)
    assert a.data_ptr() % 16
    bb = _randn(rng, (b, k, n), k ** -0.5, dtype=dtype)
    _bgemm_check(a, bb, tiling, "batched_gemm_small")
    b2 = _randn(rng, (k, n), k ** -0.5, dtype=dtype)
    _bgemm_check(a, b2, tiling, "batched_gemm_small")
    _bgemm_check(a, b2.expand(b, k, n), tiling, "batched_gemm_small")
    if dtype == torch.bfloat16:
        _bgemm_check(a, bb, tiling, "batched_gemm_small",
                     out_dtype=torch.float32)


def test_batched_gemm_small_plan_is_the_launchers(card):
    """The wrapper's plan (micro-tile, threads a matrix, teams, matrices a
    block, grid, threads, K chunk, stages, shared memory) is the CUDA
    launcher's own."""
    import ctypes

    from repro_torch.kernels import _build
    out = (ctypes.c_int * 9)()
    for bk in (16, 32, 64):
        lib = _build.load(bg.batched_gemm_kernel(True, bk))
        for m, n in ((1, 1), (3, 5), (1, 1000), (16, 16), (24, 40), (32, 32),
                     (2, 1024), (1, 2048), (45, 45), (2000, 1)):
            for k in (0, 1, 5, 16, 40, 70, 300):
                for batch, bb in ((1, 1), (7, 7), (256, 32), (16384, 32),
                                  (2000, 128)):
                    for item in (4, 2):
                        assert lib.lapis_batched_gemm_small_plan(
                            m, n, k, batch, bb, item, out) == 0
                        p = bg.small_plan(m, n, k, batch, bb, item, bk)
                        assert list(out) == [
                            p["tm"], p["tpm"], p["teams"], p["per_block"],
                            p["grid"], p["threads"], p["bk"], p["stages"],
                            p["smem_bytes"]], (m, n, k, batch, bb, item, bk)


def test_batched_gemm_small_sass_has_ldgsts(card):
    """The small kernel stages its operands by cp.async (LDGSTS)."""
    from repro_torch.kernels import _build
    assert "LDGSTS" in _build.sass(bg.batched_gemm_kernel(True, 32))


@pytest.mark.parametrize("b,m,k,n,tiling", [
    (3, 130, 70, 150, {"bm": 32, "bn": 64, "bk": 32}),
    (7, 64, 64, 64, None), (2, 257, 129, 65, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_tiled_kernel_matches_plain(card, rng, b, m, k, n,
                                                 tiling, dtype):
    a = _randn(rng, (b, m, k), dtype=dtype)
    bb = _randn(rng, (b, k, n), k ** -0.5, dtype=dtype)
    tiling = dict(tiling or bg.default_tiling(a.shape, bb.shape,
                                              a.element_size()),
                  vectorize_batch=False)
    _bgemm_check(a, bb, tiling, "batched_gemm_tiled")


@pytest.mark.parametrize("sa,sb", [((8, 256, 64), (64, 200)),
                                   ((300, 16, 16), (1, 16, 16)),
                                   ((2, 3, 20, 30), (30, 40)),
                                   ((40, 24), (6, 24, 36))])
def test_batched_gemm_reads_a_broadcast_operand_in_place(card, rng, sa, sb):
    """Stride-0 operands: B as 2-D or a size-1 batch, and A broadcast
    over B's batch; no copy of the broadcast operand is made."""
    a, b = _randn(rng, sa), _randn(rng, sb, sb[-2] ** -0.5)
    before = torch.cuda.memory_allocated()
    got = bg.batched_gemm(a, b)
    torch.cuda.synchronize()
    out_bytes = got.numel() * got.element_size()
    assert torch.cuda.memory_allocated() - before <= out_bytes + 512
    torch.testing.assert_close(got, torch.matmul(a, b), rtol=2e-4,
                               atol=2e-4)


def test_batched_gemm_bf16_to_f32_and_transposed_operands(card, rng):
    a = _randn(rng, (6, 16, 40), dtype=torch.bfloat16)
    b = _randn(rng, (6, 48, 40), 40 ** -0.5,
               dtype=torch.bfloat16).transpose(1, 2)    # 16·48 <= 1024
    for t in (None, {"bm": 16, "bn": 32, "bk": 32, "vectorize_batch": False}):
        kernel = "batched_gemm_small" if t is None else "batched_gemm_tiled"
        tiling = t or bg.default_tiling(a.shape, b.shape, 2)
        _bgemm_check(a, b, tiling, kernel, out_dtype=torch.float32)


def test_batched_gemm_refuses_what_it_does_not_take(card, rng):
    a = _randn(rng, (4, 8, 8))
    with pytest.raises(TypeError):
        bg.batched_gemm(a, a.bfloat16())
    with pytest.raises(ValueError):
        bg.batched_gemm(a, _randn(rng, (4, 9, 8)))
    with pytest.raises(ValueError):      # tiled tiling named for small
        bg.batched_gemm_small(a, a, tiling={"bm": 8, "bn": 8, "bk": 8,
                                            "vectorize_batch": False})


@pytest.mark.parametrize("sa,sb", [((256, 32, 32), (256, 32, 32)),
                                   ((16, 128, 128), (16, 128, 128)),
                                   ((2, 3, 20, 30), (2, 3, 30, 40))])
def test_compiled_batched_matmul_runs_through_the_kernels_only(card, rng,
                                                               sa, sb):
    fn = lambda x, y: ops.matmul(x, y)   # noqa: E731
    a, b = _randn(rng, sa), _randn(rng, sb)
    mod = pipeline.compile(fn, TensorSpec(sa, "float32"),
                           TensorSpec(sb, "float32"),
                           options=CompileOptions(target="cuda"))
    before = _bgemm_counts()
    got = mod(a, b)
    torch.cuda.synchronize()
    after = _bgemm_counts()
    assert sum(after[n][0] - before[n][0] for n in after) == 1
    assert all(after[n][1] == before[n][1] for n in after)
    lib = pipeline.compile(fn, TensorSpec(sa, "float32"),
                           TensorSpec(sb, "float32"),
                           options=CompileOptions(target="torch"))
    torch.testing.assert_close(got, lib(a, b), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the shared GEMM (kk.gemm, kk.gemv, the tiled kk.batched_gemm): bf16 on
# wgmma fed by TMA, f32 and what TMA cannot address on FFMA, split-K
# ---------------------------------------------------------------------------

def _routes(w):
    return (w.launches, w.launches_wgmma, w.launches_ffma, w.plain_calls)


def _gemm_check(a, b, out_dtype=None):
    """One ``matmul`` launch, on the route its plan names, held to the
    plain version (f32 1e-5, bf16 2e-2); returns (plan, output)."""
    m, k = a.shape
    n = b.shape[1]
    plan = mm.gemm_plan(m, n, k, 1, a.dtype,
                        mm.aligned(a.contiguous(), b.contiguous()))
    before = _routes(mm.matmul)
    got = mm.matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    wgmma = plan["route"] == "wgmma"
    assert _routes(mm.matmul) == (before[0] + 1, before[1] + wgmma,
                                  before[2] + (not wgmma), before[3])
    assert got.dtype == (out_dtype or a.dtype)
    tol = 1e-5 if a.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), torch.matmul(a.float(), b.float()),
                               rtol=tol, atol=tol)
    return plan, got


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (130, 136, 72), (257, 264, 200),
                                   (129, 64, 136), (300, 512, 1000),
                                   (64, 1000, 64), (1000, 40, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_routes_match_plain_over_ragged_edges(card, rng, m, k, n,
                                                   dtype):
    """M, N and K off every tile edge; bf16 (K, N multiples of 8) on
    wgmma, f32 on FFMA."""
    a = _randn(rng, (m, k), dtype=dtype)
    b = _randn(rng, (k, n), k ** -0.5, dtype=dtype)
    plan, _ = _gemm_check(a, b)
    assert plan["route"] == ("wgmma" if dtype == torch.bfloat16 else "ffma")


@pytest.mark.parametrize("m,k,n", [(300, 91, 400), (300, 400, 201),
                                   (77, 91, 201), (8748, 91, 400)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_misaligned_k_and_n_take_ffma(card, rng, m, k, n, dtype):
    """MALA's K = 91 and N = 201: rows off 16 bytes, staged by 4-byte
    copies (f32) or converted on load (bf16), never padded."""
    a = _randn(rng, (m, k), dtype=dtype)
    b = _randn(rng, (k, n), k ** -0.5, dtype=dtype)
    plan, _ = _gemm_check(a, b)
    assert plan["route"] == "ffma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_takes_the_ffma_route(card, rng, dtype):
    """kk.gemv's one column (N = 1) on FFMA, K split to fill the card."""
    a = _randn(rng, (1000, 777), dtype=dtype)
    x = _randn(rng, (777,), 777 ** -0.5, dtype=dtype)
    before = _routes(mm.matmul)
    got = kops.gemv_cuda(a, x)
    torch.cuda.synchronize()
    assert _routes(mm.matmul) == (before[0] + 1, before[1], before[2] + 1,
                                  before[3])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), a.float() @ x.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sa,sb", [((2048, 1536), (1536, 8960)),
                                   ((12, 2048, 128), (12, 128, 2048))])
def test_bf16_wgmma_error_against_f64_is_the_plain_versions(card, rng, sa,
                                                            sb):
    """At the MLP up-projection and the per-head QKᵀ, the wgmma route's
    mean |error| against an f64 evaluation of the same bf16 inputs is
    within 1.5× the plain version's (both round C to bf16 once)."""
    a = _randn(rng, sa, dtype=torch.bfloat16)
    b = _randn(rng, sb, sb[-2] ** -0.5, dtype=torch.bfloat16)
    if len(sa) == 2:
        before = mm.matmul.launches_wgmma
        got, plain = mm.matmul(a, b), ref.matmul(a, b)
        assert mm.matmul.launches_wgmma == before + 1
    else:
        before = bg.batched_gemm_tiled.launches_wgmma
        got = bg.batched_gemm(a, b)
        plain = ref.batched_gemm(a, b)
        assert bg.batched_gemm_tiled.launches_wgmma == before + 1
    want = torch.matmul(a.double(), b.double())
    err = float((got.double() - want).abs().mean())
    err_plain = float((plain.double() - want).abs().mean())
    assert err <= 1.5 * err_plain, (err, err_plain)


@pytest.mark.parametrize("shape,dtype", [((8, 512, 1000), torch.float32),
                                         ((8, 512, 1000), torch.bfloat16),
                                         ((1000, 777, 1), torch.float32)])
def test_split_k_is_bitwise_stable(card, rng, shape, dtype):
    """ResNet18's fc and a gemv: K split over several blocks, the partial
    products summed in a fixed order: two calls give the same bits."""
    m, k, n = shape
    plan = mm.gemm_plan(m, n, k, 1, dtype, True)
    assert plan["split"] > 1
    a = _randn(rng, (m, k), dtype=dtype)
    b = _randn(rng, (k, n), k ** -0.5, dtype=dtype)
    _, first = _gemm_check(a, b)
    for _ in range(3):
        assert torch.equal(mm.matmul(a, b), first)


def test_gemm_bf16_to_f32_on_both_routes(card, rng):
    for k, n in ((256, 200), (91, 201)):
        a = _randn(rng, (150, k), dtype=torch.bfloat16)
        b = _randn(rng, (k, n), k ** -0.5, dtype=torch.bfloat16)
        plan, _ = _gemm_check(a, b, out_dtype=torch.float32)
        assert plan["route"] == ("wgmma" if k == 256 else "ffma")
        got = bg.batched_gemm(a[None].expand(3, -1, -1), b,
                              out_dtype=torch.float32)
        torch.testing.assert_close(got, torch.matmul(a.float(), b.float())
                                   .expand(3, -1, -1), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_batched_routes_read_broadcast_strided_and_offset_operands(
        card, rng, dtype):
    """B broadcast over a packed A (folded into one product), A broadcast
    over B's batch, a strided batch of A beside a broadcast B (not
    folded), and an operand one element off 16-byte alignment (bf16: the
    FFMA route)."""
    tiled = {"bm": 64, "bn": 64, "bk": 32, "vectorize_batch": False}
    bf16 = dtype == torch.bfloat16
    cases = [(_randn(rng, (4, 96, 64), dtype=dtype),
              _randn(rng, (64, 200), 0.125, dtype=dtype), bf16),
             (_randn(rng, (40, 24), dtype=dtype),
              _randn(rng, (6, 24, 40), 0.2, dtype=dtype), bf16),
             (_randn(rng, (8, 72, 64), dtype=dtype)[::2],
              _randn(rng, (64, 48), 0.125, dtype=dtype), bf16)]
    flat = _randn(rng, (5 * 72 * 64 + 1,), dtype=dtype)
    cases.append((flat[1:].view(5, 72, 64),
                  _randn(rng, (5, 64, 48), 0.125, dtype=dtype), False))
    for a, b, on_wgmma in cases:
        before = _routes(bg.batched_gemm_tiled)
        got = bg.batched_gemm(a, b, tiling=tiled)
        torch.cuda.synchronize()
        after = _routes(bg.batched_gemm_tiled)
        assert after == (before[0] + 1, before[1] + on_wgmma,
                         before[2] + (not on_wgmma), before[3])
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(),
                                   torch.matmul(a.float(), b.float()),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_batch_beyond_the_grid_limit(card, rng, dtype):
    """70,000 matrices: blocks walk the batch past 65,535 grid slices
    (the wgmma ring's barrier phases carry across them)."""
    tiled = {"bm": 8, "bn": 8, "bk": 8, "vectorize_batch": False}
    a = _randn(rng, (70000, 8, 16), dtype=dtype)
    b = _randn(rng, (70000, 16, 8), 0.25, dtype=dtype)
    got = bg.batched_gemm(a, b, tiling=tiled)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), torch.matmul(a.float(), b.float()),
                               rtol=tol, atol=tol)


def test_gemm_plan_is_the_launchers(card):
    """lapis_gemm_plan in both libraries is the Python twin's plan."""
    import ctypes

    from repro_torch.kernels import _build
    out = (ctypes.c_int * 14)()
    libs = [_build.load(mm.matmul_kernel()),
            _build.load(bg.batched_gemm_kernel(False))]
    for lib in libs:
        for m, n, k in itertools.product((1, 8, 91, 128, 2048, 8748),
                                         (1, 8, 201, 1000, 8960),
                                         (0, 8, 91, 512, 1536, 8960)):
            for batch, fold in ((1, False), (12, False), (8, True),
                                (70000, False)):
                for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
                    for al in (True, False):
                        assert lib.lapis_gemm_plan(m, n, k, batch, item,
                                                   int(al), int(fold),
                                                   out) == 0
                        p = mm.gemm_plan(m, n, k, batch, dtype, al, fold)
                        assert list(out) == [
                            int(p["route"] == "wgmma"), p["bm"], p["bn"],
                            p["bk"], p["threads"], p["stages"], p["m"],
                            p["batch"], p["split"], p["k_chunk"],
                            *p["grid"], p["smem_bytes"]], \
                            (m, n, k, batch, fold, item, al)


def test_gemm_sass_has_wgmma_tma_and_cp_async(card):
    """Both libraries: the bf16 kernels issue HGMMA fed by UTMALDG, the
    f32 FFMA kernels stage by LDGSTS."""
    import re

    from repro_torch.kernels import _build
    for ks in (mm.matmul_kernel(), bg.batched_gemm_kernel(False)):
        fns = {}
        for part in re.split(r"(?=Function : )", _build.sass(ks))[1:]:
            name = part.split()[2]
            fns[name] = part
        sm90 = [b for n, b in fns.items() if "lapis_gemm_sm90" in n]
        f32 = [b for n, b in fns.items()
               if re.search(r"lapis_gemm_ffma_kernelIff", n)]
        assert sm90 and f32
        assert all("HGMMA" in b and "UTMALDG" in b for b in sm90)
        assert all("LDGSTS" in b for b in f32)


def test_reduced_resnet18_and_mala_cuda_match_torch(card):
    """Both models at reduced size through pipeline.compile on the card:
    the cuda target (the gemm, nest and softmax kernels; conv through
    cuDNN at f32) against the torch target."""
    from repro_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    w = resnet.init_resnet18_weights(np.random.default_rng(0),
                                     width_mult=0.25)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)).cuda()
    mw = resnet.init_mala_weights(np.random.default_rng(2))
    p = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, 91)).astype(np.float32)).cuda()
    for fn, arg, tol in ((lambda v: resnet.resnet18_forward(w, v), x,
                          dict(rtol=1e-4, atol=1e-6)),
                         (lambda v: resnet.mala_forward(mw, v), p,
                          dict(rtol=1e-4, atol=1e-4))):
        spec = TensorSpec(tuple(arg.shape), "float32")
        got = pipeline.compile(fn, spec,
                               options=CompileOptions(target="cuda"))(arg)
        want = pipeline.compile(fn, spec,
                                options=CompileOptions(target="torch"))(arg)
        torch.testing.assert_close(got, want, **tol)


# the grouped expert products' cases: (d_model, d_ff, rows an expert, act)
GROUPED_CASES = {
    # grok-1's widths: loads on both sides of 128 and of the kernels'
    # 192-row block, an empty expert and loads past 256; down splits K at
    # these 1,197 rows
    "grok": (6144, 32768, [0, 1, 127, 129, 191, 193, 256, 300], "gelu"),
    # arctic's 128 experts at small widths, many rows: no split
    "e128": (1024, 512, None, "silu"),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_kernels_match_plain(card, case, dtype):
    """Both grouped kernels against their plain versions on the same CUDA
    tensors (down fed the plain h): within one rounding of the output's
    type (2^-7 of the largest entry in bf16, 2^-10 in f16: the f32 sums
    differ in order only); one launch each, no plain call."""
    from repro_torch.kernels import grouped_gemm as gg
    M, F, loads, act = GROUPED_CASES[case]
    if loads is None:
        loads = np.random.default_rng(4).integers(0, 40, 128).tolist()
    E, R = len(loads), sum(loads)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype).mul_(scale)
    x = rand((R, M), 1.0)
    wg, wu = rand((E, M, F), M ** -0.5), rand((E, M, F), M ** -0.5)
    wd = rand((E, F, M), F ** -0.5)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(loads)]),
                           dtype=torch.int32, device="cuda")
    counts = lambda: (gg.gate_up.launches, gg.down.launches,  # noqa: E731
                      gg.gate_up.plain_calls, gg.down.plain_calls)
    before = counts()
    h = gg.gate_up(x, wg, wu, offsets, act)
    want_h = gg.plain_gate_up(x, wg, wu, offsets, act)
    y = gg.down(want_h, wd, offsets)
    want_y = gg.plain_down(want_h, wd, offsets)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, *before[2:])
    tol = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -10
    for name, got, want in (("h", h, want_h), ("y", y, want_y)):
        assert bool(torch.isfinite(got).all()), name
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= tol * scale, (name, err, scale)


def test_grok_moe_layer_takes_the_grouped_kernels_without_a_host_read(card):
    """grok-1's MoE layer at its widths on 512 tokens, bf16, no autograd:
    the grouped kernels launch once each with the card in sync-debug
    "error" mode (any host read raises), and the output is the padded
    einsums' on the same inputs within 2e-2 of its largest entry (they
    round g, u and h to bf16, the kernel h once from f32)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.models import moe
    cfg = get_config("grok-1-314b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    p = {k: torch.randn(s.shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).mul_(s.shape[-2] ** -0.5)
         for k, s in moe.moe_spec(cfg).items()}
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    before = (gg.gate_up.launches, gg.down.launches)
    torch.cuda.synchronize()
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, aux = moe.apply_moe(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (gg.gate_up.launches, gg.down.launches) == \
        (before[0] + 1, before[1] + 1)
    want, want_aux = moe.apply_moe(p, x.clone().requires_grad_(), cfg)
    assert gg.gate_up.launches == before[0] + 1
    err = float((out.float() - want.detach().float()).abs().max())
    assert err <= 2e-2 * float(want.detach().float().abs().max()), err
    assert float(aux) == float(want_aux.detach())
