"""ResNet18 and the MALA surrogate through the port's compiler on the
CPU, held to the reference: the convolution, pool and batch-norm ops
(eager and traced, XLA's asymmetric ``"SAME"`` padding at even and odd
sizes), the two models compiled on every port target against the
reference's ``xla`` and ``loops`` targets with weights carried by
``convert.from_numpy_tree``, the IR after every pass of a ResNet basic
block, and the §4.3 DualView transfer counts."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.dualview import TRANSFERS as JTRANSFERS  # noqa: E402
from repro.core.dualview import reset_transfer_stats as jreset  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.dualview import TRANSFERS, reset_transfer_stats  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import generic, matmul as tmm  # noqa: E402
from repro_torch.models import resnet  # noqa: E402

from test_torch_pipeline import _ids_normalized  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the suite runs
    in several worker processes at once, and torch's default of a thread
    a core has them fight over the cores (a test here ran ~30x slower
    beside the other workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_OP_TOL = dict(rtol=1e-5, atol=1e-5)
_PROBS_TOL = dict(rtol=1e-4, atol=1e-6)
_TARGETS = ("torch", "cuda", "loops", "auto")
WIDTH, RES, BATCH = 0.25, 32, 2
MALA_HIDDEN = (64, 48, 64)
MALA_POINTS = 37


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _both(jfn, tfn, *arrays):
    """(reference eager, port eager, port traced-and-compiled) outputs."""
    want = np.asarray(jfn(*arrays))
    got = tfn(*(_t(a) for a in arrays)).numpy()
    mod = tpipe.compile(tfn, *(TensorSpec(a.shape, "float32")
                               for a in arrays),
                        options=TOptions(target="torch", device="cpu"))
    return want, got, mod(*arrays).numpy()


@pytest.mark.parametrize("size,window,stride,padding", [
    (32, 7, 2, "SAME"), (33, 7, 2, "SAME"), (16, 3, 2, "SAME"),
    (15, 3, 2, "SAME"), (14, 3, 1, "SAME"), (8, 1, 2, "SAME"),
    (9, 3, 2, "VALID"), (10, 3, 2, ((1, 2), (0, 1)))])
def test_conv2d_matches_reference(rng, size, window, stride, padding):
    x = rng.standard_normal((2, 3, size, size + 1), dtype=np.float32)
    w = rng.standard_normal((4, 3, window, window), dtype=np.float32)
    st = (stride, stride)
    want, got, traced = _both(
        lambda a, b: jops.conv2d(a, b, stride=st, padding=padding),
        lambda a, b: tops.conv2d(a, b, stride=st, padding=padding), x, w)
    assert got.shape == traced.shape == want.shape
    np.testing.assert_allclose(got, want, **_OP_TOL)
    np.testing.assert_allclose(traced, want, **_OP_TOL)


@pytest.mark.parametrize("size,window,stride,padding", [
    (112, 3, 2, "SAME"), (16, 3, 2, "SAME"), (15, 3, 2, "SAME"),
    (9, 2, 2, "SAME"), (9, 3, 1, "SAME"), (11, 3, 2, "VALID")])
def test_max_pool2d_matches_reference(rng, size, window, stride, padding):
    x = rng.standard_normal((2, 3, size, size), dtype=np.float32)
    kw = dict(window=(window, window), stride=(stride, stride),
              padding=padding)
    want, got, traced = _both(lambda a: jops.max_pool2d(a, **kw),
                              lambda a: tops.max_pool2d(a, **kw), x)
    assert got.shape == traced.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(traced, want)


def test_avg_pool_and_batch_norm_match_reference(rng):
    x = rng.standard_normal((2, 5, 7, 6), dtype=np.float32)
    s, b, m = (rng.standard_normal(5, dtype=np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(5, dtype=np.float32)) + 0.1
    want, got, traced = _both(jops.avg_pool_global, tops.avg_pool_global, x)
    np.testing.assert_allclose(got, want, **_OP_TOL)
    np.testing.assert_allclose(traced, want, **_OP_TOL)
    want, got, traced = _both(
        lambda *a: jops.batch_norm_inference(*a, eps=1e-3),
        lambda *a: tops.batch_norm_inference(*a, eps=1e-3), x, s, b, m, v)
    np.testing.assert_allclose(got, want, **_OP_TOL)
    np.testing.assert_allclose(traced, want, **_OP_TOL)


def test_initialisers_draw_the_reference_arrays():
    want = jresnet.init_resnet18_weights(np.random.default_rng(0),
                                         width_mult=WIDTH)
    got = resnet.init_resnet18_weights(np.random.default_rng(0),
                                       width_mult=WIDTH, device="cpu")
    carried = convert.from_numpy_tree(want, "cpu")
    flat = [(k, v) for k, v in jax.tree_util.tree_leaves_with_path(want)]
    assert len(flat) == len(jax.tree_util.tree_leaves(got)) == 102
    for (path, leaf) in flat:
        keys = [p.key for p in path]
        g, c = got, carried
        for key in keys:
            g, c = g[key], c[key]
        assert torch.equal(g, c) and torch.equal(g, torch.from_numpy(leaf))
    mw = jresnet.init_mala_weights(np.random.default_rng(5))
    mg = resnet.init_mala_weights(np.random.default_rng(5), device="cpu")
    assert sorted(mw) == sorted(mg)
    assert all(torch.equal(mg[k], torch.from_numpy(mw[k])) for k in mw)


def _resnet_case(host_weights=False):
    """(reference fn, port fn, x); the port's weights are tensors carried
    by ``convert``, or the reference's numpy arrays (host-resident
    constants, as the reference's are)."""
    wj = jresnet.init_resnet18_weights(np.random.default_rng(0),
                                       width_mult=WIDTH)
    wt = wj if host_weights else convert.from_numpy_tree(wj, "cpu")
    x = np.random.default_rng(1).standard_normal(
        (BATCH, 3, RES, RES)).astype(np.float32)

    def jfn(xx):
        return jresnet.resnet18_forward(wj, xx, width_mult=WIDTH)

    def tfn(xx):
        return resnet.resnet18_forward(wt, xx, width_mult=WIDTH)
    return jfn, tfn, x


def _reset_counts():
    for w in (tmm.matmul, generic.block_map_region, generic.row_softmax):
        w.launches = w.plain_calls = 0


def test_resnet18_matches_reference_on_every_target():
    jfn, tfn, x = _resnet_case()
    want = {t: np.asarray(jpipe.compile(
        jfn, x, options=JOptions(target=t))(x)) for t in ("xla", "loops")}
    for target in _TARGETS:
        _reset_counts()
        mod = tpipe.compile(tfn, TensorSpec(x.shape, "float32"),
                            options=TOptions(target=target, device="cpu"))
        got = mod(x).numpy()
        assert got.shape == (BATCH, 1000)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)
        for t, w in want.items():
            np.testing.assert_allclose(got, w, err_msg=f"{target} vs {t}",
                                       **_PROBS_TOL)
        if target == "cuda":
            # on the CPU every kernel wrapper took its plain version: the
            # fc gemm, 17 relu / add+relu nests and the softmax nest
            assert (tmm.matmul.plain_calls,
                    generic.block_map_region.plain_calls,
                    generic.row_softmax.plain_calls) == (1, 17, 1)


def test_resnet18_ir_is_the_reference_ir():
    jfn, tfn, x = _resnet_case()
    jmod = jpipe.compile(jfn, x, options=JOptions(target="xla"))
    tmod = tpipe.compile(tfn, TensorSpec(x.shape, "float32"),
                         options=TOptions(target="torch", device="cpu"))
    assert [op.opname for op in tmod.graph.ops] == \
        [op.opname for op in jmod.graph.ops]
    for jop, top in zip(jmod.graph.ops, tmod.graph.ops):
        assert [r.type.shape for r in top.results] == \
            [tuple(r.type.shape) for r in jop.results]
    assert tmod.launch_count == jmod.launch_count


def _mala_case():
    wj = jresnet.init_mala_weights(np.random.default_rng(2),
                                   hidden=MALA_HIDDEN)
    wt = convert.from_numpy_tree(wj, "cpu")
    x = np.random.default_rng(3).standard_normal(
        (MALA_POINTS, 91)).astype(np.float32)
    return (lambda xx: jresnet.mala_forward(wj, xx),
            lambda xx: resnet.mala_forward(wt, xx), x)


def test_mala_matches_reference_on_every_target():
    """One gemm per layer; the bias + relu chains add an (n,) bias to an
    (points, n) activation, so fusion keeps them at tensor level
    (kokkos.fused, and a linalg.add for the last) in both packages."""
    jfn, tfn, x = _mala_case()
    jmods = {t: jpipe.compile(jfn, x, options=JOptions(target=t))
             for t in ("xla", "loops")}
    want = {t: np.asarray(m(x)) for t, m in jmods.items()}
    for target in _TARGETS:
        _reset_counts()
        mod = tpipe.compile(tfn, TensorSpec(x.shape, "float32"),
                            options=TOptions(target=target, device="cpu"))
        gemms = [op for op in mod.graph.ops if op.opname == "kk.gemm"]
        assert [op.operands[0].type.shape[1] for op in gemms] == \
            [91, *MALA_HIDDEN]
        if target in jmods:
            assert [op.opname for op in mod.graph.ops] == \
                [op.opname for op in jmods[target].graph.ops]
            assert mod.launch_count == jmods[target].launch_count == 8
        got = mod(x).numpy()
        assert got.shape == (MALA_POINTS, 201)
        for t, w in want.items():
            np.testing.assert_allclose(got, w, err_msg=f"{target} vs {t}",
                                       **_OP_TOL)
        if target == "cuda":     # one gemm per layer, the nests fused
            assert tmm.matmul.plain_calls == len(MALA_HIDDEN) + 1


def _basic_block_fn(mod_ops, c1, c2, s, b, m, v):
    """The reference emitter test's residual block
    (``tests/test_emitter.py::_resnet_block``) on either package's ops."""
    def fn(x):
        h = mod_ops.relu(mod_ops.batch_norm_inference(
            mod_ops.conv2d(x, mod_ops.constant(c1)), mod_ops.constant(s[0]),
            mod_ops.constant(b[0]), mod_ops.constant(m[0]),
            mod_ops.constant(v[0])))
        h = mod_ops.batch_norm_inference(
            mod_ops.conv2d(h, mod_ops.constant(c2)), mod_ops.constant(s[1]),
            mod_ops.constant(b[1]), mod_ops.constant(m[1]),
            mod_ops.constant(v[1]))
        return mod_ops.relu(mod_ops.add(h, x))
    return fn


def test_basic_block_ir_after_every_pass_matches_reference_on_loops(
        rng, capsys):
    C = 4
    c1 = (rng.standard_normal((C, C, 3, 3)) * 0.1).astype(np.float32)
    c2 = (rng.standard_normal((C, C, 3, 3)) * 0.1).astype(np.float32)
    s = np.abs(rng.standard_normal((2, C))).astype(np.float32) + 0.5
    b = rng.standard_normal((2, C)).astype(np.float32)
    m = rng.standard_normal((2, C)).astype(np.float32)
    v = np.abs(rng.standard_normal((2, C))).astype(np.float32) + 0.5
    x = rng.standard_normal((2, C, 8, 8)).astype(np.float32)
    jfn = _basic_block_fn(jops, c1, c2, s, b, m, v)
    tfn = _basic_block_fn(tops, c1, c2, s, b, m, v)
    jmod = jpipe.compile(jfn, jax.ShapeDtypeStruct(x.shape, "float32"),
                         options=JOptions(target="loops",
                                          print_ir_after_all=True))
    ref = _ids_normalized(capsys.readouterr().out)
    tmod = tpipe.compile(tfn, TensorSpec(x.shape, "float32"),
                         options=TOptions(target="loops", device="cpu",
                                          print_ir_after_all=True))
    port = _ids_normalized(capsys.readouterr().out)
    assert ref.count("// ----- IR after") == 7
    assert "kk.conv2d" in port and "linalg.batch_norm" in port
    assert port == ref
    np.testing.assert_allclose(tmod(x).numpy(), np.asarray(jmod(x)),
                               **_OP_TOL)


@pytest.mark.parametrize("lazy", [True, False])
def test_dualview_ablation_counts_the_reference_transfers(lazy):
    """§4.3: lazy DualView sync copies each host weight once; the eager
    baseline also round-trips every value around every kernel.  One
    call, both packages, the weights on the host in both."""
    jfn, tfn, x = _resnet_case(host_weights=True)
    jmod = jpipe.compile(jfn, x, jit=False,
                         options=JOptions(target="xla", lazy_dualview=lazy))
    jreset()
    jmod(x)
    want = JTRANSFERS["h2d"] + JTRANSFERS["d2h"]
    tmod = tpipe.compile(tfn, TensorSpec(x.shape, "float32"),
                         options=TOptions(target="torch", device="cpu",
                                          lazy_dualview=lazy))
    reset_transfer_stats()
    tmod(x)
    assert TRANSFERS["h2d"] + TRANSFERS["d2h"] == want
    n_weights = 102
    assert (want == n_weights) if lazy else want > 2 * n_weights
