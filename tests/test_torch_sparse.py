"""The port's sparse path held to the JAX reference and scipy on the CPU.

``ops.spmv_csr`` / ``ops.spmm_csr`` compile their one-op graph through
the port's pipeline on every port target (``device="cpu"``, so the
``cuda`` kernels run their plain versions), and must match scipy and the
reference's ``repro.core.ops`` on the same seeded matrices to 1e-5 — the
three matrices of the reference's sparse tests, one whose last rows are
empty, nnz = 0 and zero rows.  The kernel module ``kernels/spmv.py`` is
held to the reference's (ELL conversion, plain versions, the Pallas ELL
kernels in interpret mode), ``--demo spmv`` to the reference's demo, and
every tiling the sparsify pass can emit on the H100 hierarchy to what the
CUDA kernels accept.
"""
import contextlib
import io
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
scipy_sparse = pytest.importorskip("scipy.sparse")
import torch  # noqa: E402

from repro.core import ir as jir  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import tracer as jtracer  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.core.options import use_options as juse  # noqa: E402
from repro.kernels import spmm as jspmm  # noqa: E402
from repro.kernels import spmv as jspmv  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import tracer as ttracer  # noqa: E402
from repro_torch.core.backend import H100_HIERARCHY  # noqa: E402
from repro_torch.core.costmodel import CostModel  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.core.passes import (candidate_spmv_tilings,  # noqa: E402
                                     choose_spmv_tiling)
from repro_torch.kernels import generic, spmm as tspmm  # noqa: E402
from repro_torch.kernels import spmv as tspmv  # noqa: E402

PORT_TARGETS = ["auto", "cuda", "loops", "torch"]


def _random():
    return scipy_sparse.random(100, 80, density=0.1, format="csr",
                               random_state=np.random.default_rng(0),
                               dtype=np.float32)


def _empty_rows():
    """Half the rows empty (the paper's StocF-like irregularity)."""
    dense = np.zeros((8, 6), np.float32)
    dense[1] = np.arange(1, 7)
    dense[4, 2] = 3.0
    dense[7, 5] = -2.0
    return scipy_sparse.csr_matrix(dense)


def _dense_row():
    """One fully-dense row among sparse ones (max_nnz_row >> nnz_mean)."""
    dense = np.zeros((16, 32), np.float32)
    dense[3] = np.linspace(-1, 1, 32)
    dense[0, 0] = 1.0
    dense[9, 31] = 5.0
    return scipy_sparse.csr_matrix(dense)


def _trailing_empty():
    """The last rows are empty, so indptr[i] == nnz for them: the index
    a scatter-built row map would write out of range."""
    dense = np.zeros((10, 7), np.float32)
    dense[0, :3] = (1.0, -2.0, 0.5)
    dense[2, 6] = 4.0
    dense[5] = np.arange(7) - 3.0
    return scipy_sparse.csr_matrix(dense)


def _nnz_zero():
    return scipy_sparse.csr_matrix((7, 5), dtype=np.float32)


def _zero_rows():
    return scipy_sparse.csr_matrix((0, 4), dtype=np.float32)


MATRICES = {"random": _random, "empty-rows": _empty_rows,
            "dense-row": _dense_row, "trailing-empty": _trailing_empty,
            "nnz-zero": _nnz_zero, "zero-rows": _zero_rows}


def _csr(a):
    return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
            a.data.astype(np.float32))


def _dense_operand(a, cols):
    rng = np.random.default_rng(1)
    shape = (a.shape[1],) if cols is None else (a.shape[1], cols)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("target", PORT_TARGETS)
@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_sparse_ops_every_target_match_scipy_and_reference(op, matrix,
                                                           target):
    a = MATRICES[matrix]()
    n = a.shape[0]
    ip, ind, val = _csr(a)
    dense = _dense_operand(a, None if op == "spmv" else 9)
    want = a @ dense
    with juse(JOptions(target="xla")):
        ref = np.asarray(getattr(jops, f"{op}_csr")(ip, ind, val, dense,
                                                    n_rows=n))
    with tuse(TOptions(target=target, device="cpu")):
        got = getattr(tops, f"{op}_csr")(ip, ind, val, dense, n_rows=n)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _spmv_fn(n, max_nnz_row):
    def f(ip, ind, val, x):
        return tops.spmv_csr(ip, ind, val, x, n_rows=n,
                             max_nnz_row=max_nnz_row)
    return f


@pytest.mark.parametrize("target", PORT_TARGETS)
def test_only_loops_converts_to_ell(target):
    """The cuda kernels read CSR: only the ell-layout `loops` backend
    gets the sparse.convert, even with the static width known."""
    a = _random()
    ip, ind, val = _csr(a)
    x = _dense_operand(a, None)
    mod = tpipe.compile(_spmv_fn(a.shape[0], int(np.diff(ip).max())),
                        ip, ind, val, x,
                        options=TOptions(target=target, device="cpu"))
    names = [op.opname for op in mod.graph.ops]
    assert names.count("sparse.convert") == (target == "loops")
    assert names.count("kk.spmv") == 1 and "sparse.pack" in names
    np.testing.assert_allclose(mod(ip, ind, val, x).numpy(), a @ x,
                               rtol=1e-5, atol=1e-5)


def _reset_counts():
    for w in (tspmv.spmv, tspmm.spmm_sparse, generic.block_map_region):
        w.launches = w.plain_calls = 0


@pytest.mark.parametrize("ref_target", ["pallas", "xla"])
def test_spmv_demo_matches_reference(ref_target):
    jfn, jspecs, ex = jpipe._demo_spmv()
    tfn, tspecs, tex = tpipe._demo_spmv()
    for a, b in zip(ex, tex):
        np.testing.assert_array_equal(a, b)
    jmod = jpipe.compile(jfn, *jspecs, options=JOptions(
        target=ref_target, interpret=True))
    _reset_counts()
    tmod = tpipe.compile(tfn, *tspecs,
                         options=TOptions(target="cuda", device="cpu"))
    got = tmod(*tex).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod(*ex)), rtol=1e-5,
                               atol=1e-5)
    # sparse.pack, kk.spmv and the relu nest; the reference's pallas
    # backend adds its ELL conversion
    assert tmod.launch_count == 3
    assert jmod.launch_count == 3 + (ref_target == "pallas")
    assert (tspmv.spmv.plain_calls,
            generic.block_map_region.plain_calls) == (1, 1)
    assert tspmv.spmv.launches == generic.block_map_region.launches == 0


def _cli(main, demo, target, capsys, *extra):
    assert main(["--demo", demo, "--target", target, *extra]) == 0
    return capsys.readouterr().out.strip().splitlines()[-1]


def _shape_and_sum(line):
    shape, total = line.split("sum:")
    return shape.replace("output shape:", "").strip(), float(total)


@pytest.mark.parametrize("demo", ["spmv", "paged", "paged_swap"])
def test_cli_demo_prints_the_reference_shape_and_sum(demo, capsys):
    ref = _shape_and_sum(_cli(jpipe.main, demo, "xla", capsys))
    got = _shape_and_sum(_cli(tpipe.main, demo, "cuda", capsys,
                              "--device", "cpu"))
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], rel=1e-5)


def test_trace_puts_encodings_on_argument_types():
    """``trace(..., encodings=)`` types an argument as a sparse-encoded
    value, printed as the reference prints it."""
    stats = dict(format="csr", nnz=20, nnz_mean=2.5, max_nnz_row=4)
    jg = jtracer.trace(lambda a: a, jax.ShapeDtypeStruct((8, 10), "float32"),
                       encodings=[jir.SparseEncoding(**stats)])
    tg = ttracer.trace(lambda a: a, ttracer.TensorSpec((8, 10), "float32"),
                       encodings=[tir.SparseEncoding(**stats)])
    assert tg.inputs[0].type.encoding == tir.SparseEncoding(**stats)
    assert str(tg.inputs[0].type) == str(jg.inputs[0].type)
    plain = ttracer.trace(lambda a: a, ttracer.TensorSpec((8, 10), "float32"))
    assert plain.inputs[0].type.encoding is None


# ---------------------------------------------------------------------------
# kernels/spmv.py and kernels/spmm.py against the reference's modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("max_nnz_row", [None, 40])
def test_csr_to_ell_matches_reference(matrix, max_nnz_row):
    a = MATRICES[matrix]()
    ip, ind, val = _csr(a)
    n, m = a.shape
    if n == 0 and max_nnz_row is None:
        max_nnz_row = 0
    want = jspmv.csr_to_ell(ip, ind, val, n, m, max_nnz_row=max_nnz_row)
    got = tspmv.csr_to_ell(torch.from_numpy(ip), torch.from_numpy(ind),
                           torch.from_numpy(val), n, m,
                           max_nnz_row=max_nnz_row)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3:] == tuple(want[3:])


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_kernel_modules_match_pallas_ell_kernels(matrix):
    """The port's SpMV and SpMM wrappers (plain versions on the CPU, on
    CSR and on ELL) against the reference's Pallas ELL kernels run in
    interpret mode."""
    a = MATRICES[matrix]()
    ip, ind, val = _csr(a)
    n, m = a.shape
    x, b = _dense_operand(a, None), _dense_operand(a, 5)
    width = max(int(np.diff(ip).max()) if n else 0, 1)
    jell = jspmv.csr_to_ell(ip, ind, val, n, m, max_nnz_row=width)
    want_v = np.asarray(jspmv.spmv_ell(jell, x, interpret=True))
    want_m = np.asarray(jspmm.spmm_ell(jell, b, interpret=True))
    csr = tspmv.CsrMatrix(*(torch.from_numpy(t) for t in (ip, ind, val)),
                          n, m)
    ell = tspmv.as_ell(csr, max_nnz_row=width)
    _reset_counts()
    for operand in (csr, ell):
        np.testing.assert_allclose(
            tspmv.spmv(operand, torch.from_numpy(x)).numpy(), want_v,
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tspmm.spmm_sparse(operand, torch.from_numpy(b)).numpy(),
            want_m, rtol=1e-5, atol=1e-5)
    assert tspmv.spmv.plain_calls == tspmm.spmm_sparse.plain_calls == 2
    assert tspmv.spmv.launches == tspmm.spmm_sparse.launches == 0


def test_zero_rows_regression():
    """n_rows == 0 (the reference's csr_to_ell regressions): a
    well-formed all-padding ELL, and a product of shape (0,)."""
    ip = torch.zeros(1, dtype=torch.int32)
    ind = torch.zeros(0, dtype=torch.int32)
    val = torch.zeros(0)
    ell = tspmv.csr_to_ell(ip, ind, val, 0, 4)
    assert ell.values.shape == ell.indices.shape == ell.valid.shape == (0, 8)
    assert tspmv.csr_to_ell(ip, ind, val, 0, 4,
                            max_nnz_row=3).values.shape == (0, 8)
    x = torch.ones(4)
    assert tuple(tspmv.spmv(ell, x).shape) == (0,)
    assert tuple(tspmv.spmv_csr(ip, ind, val, x, n_rows=0).shape) == (0,)
    b = torch.ones(4, 3)
    assert tuple(tspmm.spmm_sparse(ell, b).shape) == (0, 3)


# ---------------------------------------------------------------------------
# tilings and the no-fallback rule
# ---------------------------------------------------------------------------

def test_h100_hierarchy_only_yields_tilings_the_kernels_run():
    """Every tiling choose_spmv_tiling / candidate_spmv_tilings (and the
    cost model's pick among them) yields on the H100 hierarchy passes the
    SpMV and SpMM launchers' check, so none can raise on the card."""
    model = CostModel(H100_HIERARCHY)
    rows = (0, 1, 5, 8, 100, 1000, 65_536, 648_000, 742_793, 1_465_137)
    means = (0.0, 0.5, 1.0, 7.9, 8.0, 12.0, 14.34, 24.0, 31.0, 33.0, 50.0,
             78.33, 82.28, 345.0)
    seen = set()
    for n_rows, mean in itertools.product(rows, means):
        # the sparsify pass takes its tiling from the candidates, whose
        # clamp lifts the zero-row heuristic's row_block 0 to 1; a
        # zero-row product launches nothing
        cands = candidate_spmv_tilings(n_rows, mean, H100_HIERARCHY)
        picked = model.rank(cands, lambda t: model.spmv_cost(
            n_rows, mean, 4, t))[0][1]
        tilings = cands + [picked]
        if n_rows:
            tilings.append(choose_spmv_tiling(n_rows, mean, H100_HIERARCHY))
        for t in tilings:
            seen.add(tspmv.check_tiling(t))
    widths = {w for _, w in seen}
    assert widths == {8, 16, 24, 32}        # every width the clamp allows
    assert max(rb for rb, _ in seen) * 32 > 1024   # blocks that loop


@pytest.mark.parametrize("tiling", [{"row_block": 0, "row_width": 8},
                                    {"row_block": 8, "row_width": 0},
                                    {"row_block": 8, "row_width": 33}])
def test_sparse_kernels_refuse_tilings_they_cannot_run(tiling):
    with pytest.raises(ValueError):
        tspmv.check_tiling(tiling)


def test_sparse_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only CPU tensors reach a plain version; on any other device (here
    ``meta``, standing in for a card) the wrappers launch or raise."""
    ip = torch.zeros(5, dtype=torch.int32, device="meta")
    ind = torch.zeros(3, dtype=torch.int32, device="meta")
    val = torch.zeros(3, device="meta")
    csr = tspmv.CsrMatrix(ip, ind, val, 4, 6)
    _reset_counts()
    with pytest.raises(ValueError):
        tspmv.spmv(csr, torch.zeros(6, device="meta"))
    with pytest.raises(ValueError):
        tspmm.spmm_sparse(csr, torch.zeros(6, 2, device="meta"))
    with pytest.raises(ValueError):      # mixed devices
        tspmv.spmv(csr, torch.zeros(6))
    assert tspmv.spmv.plain_calls == tspmm.spmm_sparse.plain_calls == 0


def test_sparse_kernel_sources_are_listed_for_the_build():
    from repro_torch.kernels import ops as kops
    a = _random()
    ip, ind, val = _csr(a)
    b = _dense_operand(a, 3)

    def both(ipv, indv, valv, xv, bv):
        y = tops.spmv_csr(ipv, indv, valv, xv, n_rows=a.shape[0])
        return y, tops.spmm_csr(ipv, indv, valv, bv, n_rows=a.shape[0])

    mod = tpipe.compile(both, ip, ind, val, _dense_operand(a, None), b,
                        options=TOptions(target="cuda", device="cpu"))
    names = [ks.name for ks in kops.kernel_sources(mod.graph)]
    assert names == ["spmv", "spmm"]


def test_sparsify_appears_in_the_pipeline_dump():
    a = _random()
    ip, ind, val = _csr(a)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod = tpipe.compile(_spmv_fn(a.shape[0], None), ip, ind, val,
                            _dense_operand(a, None),
                            options=TOptions(target="cuda", device="cpu",
                                             print_ir_after_all=True))
    dump = buf.getvalue()
    assert "IR after sparsify" in dump and "kk.spmv" in dump
    assert mod.graph.pipeline_stats["sparsify"] == 1
    (spmv,) = [op for op in mod.graph.ops if op.opname == "kk.spmv"]
    assert spmv.attrs["tiling"] == choose_spmv_tiling(
        a.shape[0], a.nnz / a.shape[0], H100_HIERARCHY)
