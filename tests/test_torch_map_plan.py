"""The launch plans of the mapped-nest kernel and CSR SpMM on the CPU
(``kernels/generic.py::map_plan``, the twin of ``plan`` in
``csrc/block_map.cuh``; ``kernels/spmm.py::spmm_plan``, the twin of
``plan`` in ``csrc/spmm.cu``; the card tests hold each equal to its C
twin): every element or column covered once, the grid within the card's
limits, the scalar path taken exactly when it must be.  Then SpMM's order
of summation (entries dealt to lane groups, then a fixed shuffle tree)
evaluated on the CPU and held to the JAX reference's Pallas ELL kernel
(interpret mode) and to the port's plain version, and the nest wrapper's
``block`` argument shown not to reach the launch."""
import functools
import itertools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
scipy_sparse = pytest.importorskip("scipy.sparse")
import torch  # noqa: E402

from repro.kernels import spmm as jspmm  # noqa: E402
from repro.kernels import spmv as jspmv  # noqa: E402
from repro_torch.core import ops, pipeline  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import generic, ref  # noqa: E402
from repro_torch.kernels import spmm as tspmm  # noqa: E402
from test_torch_sparse import MATRICES, _csr  # noqa: E402

SMS = 132   # H100 SXM
# element counts: empty, below one vector, ragged tails, one block's
# vectors, the grid's cap, the MLP block's residual add (2048 x 1536) and
# silu.mul (2048 x 8960) at qwen2-1.5b's widths
MAP_SIZES = (0, 1, 3, 7, 8, 9, 1001, 4096, 4097, 135_168 * 4 + 5,
             2048 * 1536, 2048 * 8960)
# operands then output: two f32, two bf16, mixed, one operand, and seven
# f32 operands (a long fused chain: one vector a step)
ITEMSIZES = ((4, 4, 4), (2, 2, 2), (4, 2, 4), (2, 4, 2), (4, 4),
             (4,) * 8)


def _map_elements(p: dict, n: int) -> np.ndarray:
    """Every element index the kernel's threads touch, in launch order:
    thread t of the grid takes vectors t, t + S, ..., t + (unroll - 1) S
    a step (S the grid's threads) and steps by unroll x S; the tail's
    elements go to threads 0 .. tail - 1."""
    s = p["grid"] * p["threads"]
    t = np.arange(s)
    steps = -(-p["vectors"] // (p["unroll"] * s)) if s else 0
    v = (t[None, None, :] + (np.arange(steps)[:, None, None] * p["unroll"]
                             + np.arange(p["unroll"])[None, :, None]) * s)
    v = v[v < p["vectors"]]
    els = (v[:, None] * p["vec"] + np.arange(p["vec"])).ravel()
    tail = p["vectors"] * p["vec"] + t[t < p["tail"]]
    return np.concatenate([els, tail])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsizes", ITEMSIZES, ids=str)
@pytest.mark.parametrize("n", MAP_SIZES)
def test_map_plan_covers_every_element_once(n, itemsizes, aligned):
    p = generic.map_plan(n, itemsizes, aligned, SMS)
    assert p["vec"] == (16 // max(itemsizes) if aligned else 1)
    assert p["vectors"] * p["vec"] + p["tail"] == n
    assert 0 <= p["tail"] < p["vec"]
    assert p["threads"] == generic.MAP_THREADS and p["threads"] % 32 == 0
    # the loaded operands a thread holds a step fit the byte budget, or
    # it takes one vector
    held = p["unroll"] * p["vec"] * sum(itemsizes[:-1])
    assert 1 <= p["unroll"] <= generic.MAP_MAX_UNROLL
    assert held <= generic.MAP_INFLIGHT_BYTES or p["unroll"] == 1
    assert p["unroll"] == generic.MAP_MAX_UNROLL or \
        held + p["vec"] * sum(itemsizes[:-1]) > generic.MAP_INFLIGHT_BYTES
    assert (p["grid"] >= 1) == (n > 0)
    assert p["grid"] <= SMS * generic.MAP_BLOCKS_PER_SM
    if n <= 2 ** 24:
        els = _map_elements(p, n)
        assert np.array_equal(np.sort(els), np.arange(n))
    # no more blocks than the vectors fill
    assert (p["grid"] - 1) * p["threads"] * p["unroll"] < max(p["vectors"], 1)


@pytest.mark.parametrize("n", [2048 * 1536, 2048 * 8960])
def test_map_plan_fills_the_card_at_the_block_widths(n):
    """The MLP block's nests take 16-byte vectors (4 f32, 8 bf16) and
    every SM's resident blocks where their vectors fill them (all but the
    bf16 residual add: 384 blocks of 4 x 256 vectors); the launch does
    not depend on a tile."""
    cap = SMS * generic.MAP_BLOCKS_PER_SM
    for its, vec in (((4, 4, 4), 4), ((2, 2, 2), 8)):
        p = generic.map_plan(n, its, True, SMS)
        want = min(cap, -(-n // (vec * generic.MAP_THREADS * 4)))
        assert p["unroll"] == 4
        assert (p["vec"], p["grid"], p["tail"]) == (vec, want, 0)
        assert p["grid"] == cap or (vec, n) == (8, 2048 * 1536)


def _spmm_columns(p: dict, n: int) -> list:
    """The columns the kernel's lanes write: lane l of a group in column
    block by holds columns (by x lanes + l) x vec ... + vec - 1, when its
    first lies inside the row."""
    cols = []
    for by, lane in itertools.product(range(p["grid_cols"]),
                                      range(p["lanes"])):
        c0 = (by * p["lanes"] + lane) * p["vec"]
        if c0 < n:
            cols += range(c0, c0 + p["vec"])
    return cols


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("row_block", [1, 3, 8, 256, 1000])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 17, 40, 64, 128, 129, 256,
                               300, 1000])
def test_spmm_plan_covers_every_column_and_row_once(n, row_block, itemsize,
                                                    aligned):
    n_rows = 742_793
    p = tspmm.spmm_plan(n_rows, n, row_block, itemsize, aligned)
    v16 = 16 // itemsize
    assert p["vec"] == (v16 if aligned and n % v16 == 0 else 1)
    assert p["lanes"] in (1, 2, 4, 8, 16, 32)
    assert p["lanes"] * p["groups"] == 32
    assert p["cols"] == p["lanes"] * p["vec"]
    # the fewest lanes that cover the row, up to the warp
    assert p["lanes"] == 32 or p["lanes"] * p["vec"] >= n
    assert p["lanes"] == 1 or (p["lanes"] // 2) * p["vec"] < n
    assert sorted(_spmm_columns(p, n)) == list(range(n))
    assert p["threads"] == min(row_block, tspmm.MAX_WARPS) * 32
    assert p["grid_rows"] * row_block >= n_rows > \
        (p["grid_rows"] - 1) * row_block
    assert p["grid_cols"] <= tspmm.MAX_COL_BLOCKS
    assert p["unroll"] == (1 if p["vec"] > 1 else 8)


def test_spmm_plan_at_pflow_742_by_16():
    """The measured case: 4 lanes of float4 read a 64-byte B row, 8
    groups take 8 entries at a time."""
    p = tspmm.spmm_plan(742_793, 16, 256, 4)
    assert (p["vec"], p["lanes"], p["groups"], p["cols"], p["grid_cols"]) \
        == (4, 4, 8, 16, 1)
    assert tspmm.spmm_plan(742_793, 16, 256, 2)["lanes"] == 2


def spmm_in_kernel_order(indptr, cols, vals, b, p: dict) -> np.ndarray:
    """Y = A @ B summed in ``csrc/spmm.cu``'s order, in f32: a row's
    entries are read in stream vectors of 4 (1 on the scalar path)
    aligned to the arrays' start, 32 vectors a chunk; group g of the
    warp takes the vectors g, g + groups, ... of a chunk, entry by entry;
    then the groups' sums meet in the xor tree over group offsets
    groups / 2, ..., 1, and group 0's sum is the row."""
    e_vec = 4 if p["vec"] > 1 else 1
    groups = p["groups"]
    y = np.zeros((len(indptr) - 1, b.shape[1]), np.float32)
    for row in range(len(indptr) - 1):
        j0, j1 = int(indptr[row]), int(indptr[row + 1])
        acc = np.zeros((groups, b.shape[1]), np.float32)
        if j1 > j0:
            q1 = (j1 - 1) // e_vec
            for qb in range(j0 // e_vec, q1 + 1, 32):
                live = min(32, q1 - qb + 1)
                for s, g, e in itertools.product(range(-(-live // groups)),
                                                 range(groups),
                                                 range(e_vec)):
                    j = (qb + s * groups + g) * e_vec + e
                    if s * groups + g < live and j0 <= j < j1:
                        acc[g] = acc[g] + np.float32(vals[j]) * b[cols[j]]
        o = groups // 2
        while o >= 1:
            acc = acc + acc[np.arange(groups) ^ o]
            o //= 2
        y[row] = acc[0]
    return y


def _long_rows():
    """Rows of 0, 1, 345 and 130 entries among short ones: several
    32-vector chunks a row, and rows that start off the 4-entry vector."""
    rng = np.random.default_rng(3)
    lens = [0, 1, 345, 3, 130, 0, 7, 345, 1, 2]
    dense = np.zeros((len(lens), 400), np.float32)
    for r, k in enumerate(lens):
        dense[r, rng.choice(400, k, replace=False)] = \
            rng.standard_normal(k).astype(np.float32)
    return scipy_sparse.csr_matrix(dense)


SPMM_MATRICES = {**MATRICES, "long-rows": _long_rows}


@functools.lru_cache(maxsize=None)
def _jax_spmm(matrix: str, n: int) -> tuple:
    a = SPMM_MATRICES[matrix]()
    ip, ind, val = _csr(a)
    b = np.random.default_rng(n).standard_normal((a.shape[1], n)) \
        .astype(np.float32)
    width = max(int(np.diff(ip).max()) if a.shape[0] else 0, 1)
    jell = jspmv.csr_to_ell(ip, ind, val, *a.shape, max_nnz_row=width)
    return (ip, ind, val, b,
            np.asarray(jspmm.spmm_ell(jell, b, interpret=True)))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 3, 16, 17, 40])
@pytest.mark.parametrize("matrix", sorted(SPMM_MATRICES))
def test_spmm_kernel_order_matches_the_references(matrix, n, aligned):
    ip, ind, val, b, want_jax = _jax_spmm(matrix, n)
    p = tspmm.spmm_plan(len(ip) - 1, n, 8, 4, aligned)
    got = spmm_in_kernel_order(ip, ind, val, b, p)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    want = ref.spmm_csr(*(torch.from_numpy(t) for t in (ip, ind, val, b)),
                        n_rows=len(ip) - 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nest_block_does_not_steer_the_launch(monkeypatch):
    """``block_map_region`` keeps the reference's ``block`` argument, but
    the launch takes only the operands, the output and the element count
    (the C plan): two tilings make the same call.  The library and the
    card are stood in for, so the call is recorded, not run."""
    spec = TensorSpec((33, 130), "float32")
    mod = pipeline.compile(lambda g, u: ops.silu(g) * u, spec, spec,
                           options=CompileOptions(target="cuda",
                                                  device="cpu"))
    (nest,) = [o for o in mod.graph.ops if o.opname == "kokkos.team_parallel"]
    calls = []

    def launch(ptrs, n, stream):
        calls.append((len(ptrs), n, stream))
        return 0

    lib = types.SimpleNamespace(lapis_region_launch=launch)
    monkeypatch.setattr(generic._build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(generic, "region_library", lambda *a: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    args = [torch.ones(33, 130), torch.ones(33, 130)]
    before = generic.block_map_region.launches
    for block in ((1, 1024), (33, 130), (8, 16)):
        generic.block_map_region(nest.regions[0], args, (33, 130),
                                 "float32", block=block)
    assert generic.block_map_region.launches == before + 3
    assert calls == [(3, 33 * 130, 7)] * 3
