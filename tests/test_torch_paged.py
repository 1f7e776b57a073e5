"""The port's block-paged KV-cache path held to the JAX reference on the
CPU.

The same seeded pools, page tables and ids go through the reference's
``kernels/paged_kv.py`` (xla, loops, and the Pallas gather in interpret
mode) and the port's (torch, loops, and the CUDA gather's plain version
on CPU tensors): every copy is exact.  The eager ``core.ops`` paged ops
compile their one-op graph on every port target, ``--demo paged`` and
``--demo paged_swap`` match the reference's demos, and ``--analyze``
reports what the reference reports, including the copy-on-write error.
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import analysis as janalysis  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.core.options import use_options as juse  # noqa: E402
from repro.kernels import paged_kv as jpk  # noqa: E402
from repro_torch.convert import numpy_to_torch  # noqa: E402
from repro_torch.core import analysis as tanalysis  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_kv as tpk  # noqa: E402

PORT_TARGETS = ["auto", "cuda", "loops", "torch"]
# (n_blocks, heads, block_size, head_dim, n_slots, blocks_per_slot)
GEOMETRIES = [(17, 2, 8, 16, 4, 4), (9, 1, 5, 3, 3, 2), (33, 4, 16, 8, 2, 7)]
DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}


def _pool(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32).astype(
        DTYPES[dtype])


def _paged_case(geom, dtype, seed=0):
    nb, h, bs, hd, s, mb = geom
    rng = np.random.default_rng(seed)
    pool = _pool(rng, (nb, h, bs, hd), dtype)
    # distinct blocks per slot (block 0 is the scrap block), so no two
    # slots append to the same place and the scatter order cannot matter
    table = rng.permutation(np.arange(1, nb))[:s * mb].reshape(s, mb) \
        .astype(np.int32)
    lengths = np.array([(7 * i) % (mb * bs) for i in range(s)], np.int32)
    kv = _pool(rng, (s, h, hd), dtype)
    return pool, table, lengths, kv


def _t(a):
    return numpy_to_torch(np.asarray(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_gather_implementations_match_reference_exactly(geom, dtype):
    pool, table, lengths, _ = _paged_case(geom, dtype)
    bs = geom[2]
    want = _jnp(jpk.page_gather_pallas(pool, table, lengths, block_size=bs,
                                       interpret=True))
    np.testing.assert_array_equal(
        _jnp(jpk.page_gather_xla(pool, table, lengths, block_size=bs)),
        want)
    before = tpk.page_gather.plain_calls
    for impl in (tpk.page_gather, tpk.page_gather_torch,
                 tpk.page_gather_loops):
        got = impl(_t(pool), _t(table), _t(lengths), block_size=bs)
        assert got.dtype == _t(pool).dtype
        np.testing.assert_array_equal(_np(got), want)
    assert tpk.page_gather.plain_calls == before + 1
    assert tpk.page_gather.launches == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_append_implementations_match_reference_exactly(geom, dtype):
    pool, table, lengths, kv = _paged_case(geom, dtype)
    bs = geom[2]
    jargs = [jnp.asarray(a) for a in (pool, table, lengths, kv)]
    want = _jnp(jpk.page_append_xla(*jargs, block_size=bs))
    np.testing.assert_array_equal(
        _jnp(jpk.page_append_loops(*jargs, block_size=bs)), want)
    for impl in (tpk.page_append_torch, tpk.page_append_loops):
        got = impl(_t(pool), _t(table), _t(lengths), _t(kv), block_size=bs)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("layers", [None, 3])
def test_copy_implementations_match_reference_exactly(layers):
    rng = np.random.default_rng(4)
    lead = () if layers is None else (layers,)
    dst = rng.standard_normal(lead + (9, 2, 8, 16)).astype(np.float32)
    src = rng.standard_normal(lead + (5, 2, 8, 16)).astype(np.float32)
    src_ids = np.array([4, 0, 2], np.int32)
    dst_ids = np.array([1, 7, 3], np.int32)
    jargs = [jnp.asarray(a) for a in (dst, src, src_ids, dst_ids)]
    want = np.asarray(jpk.page_copy_xla(*jargs, block_size=8))
    np.testing.assert_array_equal(
        np.asarray(jpk.page_copy_loops(*jargs, block_size=8)), want)
    for impl in (tpk.page_copy_torch, tpk.page_copy_loops):
        got = impl(_t(dst), _t(src), _t(src_ids), _t(dst_ids), block_size=8)
        np.testing.assert_array_equal(got.numpy(), want)
    # the CoW fork copies inside one pool: reads see the pool before it
    fork = tpk.page_copy_torch(_t(dst), _t(dst), _t(src_ids), _t(dst_ids),
                               block_size=8)
    np.testing.assert_array_equal(
        fork.numpy(), np.asarray(jpk.page_copy_xla(
            jargs[0], jargs[0], *jargs[2:], block_size=8)))


@pytest.mark.parametrize("target", PORT_TARGETS)
def test_eager_paged_ops_every_target_match_reference(target):
    pool, table, lengths, kv = _paged_case(GEOMETRIES[0], "float32")
    swap = np.zeros((5, 2, 8, 16), np.float32)
    pool_ids, swap_ids = np.array([3, 5], np.int32), np.array([0, 4],
                                                              np.int32)

    def run(o):
        return [o.page_append(pool, table, lengths, kv, block_size=8),
                o.page_gather(pool, table, lengths, block_size=8),
                o.page_copy(pool, pool, pool_ids, swap_ids, block_size=8),
                o.page_swap_out(swap, pool, pool_ids, swap_ids,
                                block_size=8),
                o.page_swap_in(pool, swap + 1, swap_ids, pool_ids,
                               block_size=8)]

    with juse(JOptions(target="xla")):
        want = run(jops)
    with tuse(TOptions(target=target, device="cpu")):
        got = run(tops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _reset_counts():
    tpk.page_gather.launches = tpk.page_gather.plain_calls = 0


@pytest.mark.parametrize("ref_target", ["pallas", "xla"])
@pytest.mark.parametrize("demo", ["paged", "paged_swap"])
def test_paged_demos_match_reference(demo, ref_target):
    jfn, jspecs, ex = jpipe._DEMOS[demo]()
    tfn, tspecs, tex = tpipe._DEMOS[demo]()
    jmod = jpipe.compile(jfn, *jspecs, options=JOptions(
        target=ref_target, interpret=True))
    _reset_counts()
    tmod = tpipe.compile(tfn, *tspecs,
                         options=TOptions(target="cuda", device="cpu"))
    got = tmod(*tex).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod(*ex)), rtol=1e-5,
                               atol=1e-5)
    assert tmod.launch_count == jmod.launch_count == 2
    # the gather is the one op with a hand kernel: its wrapper took the
    # plain version on the CPU; append and copies went to torch
    assert tpk.page_gather.plain_calls == (demo == "paged")
    assert tpk.page_gather.launches == 0
    lowered = [op.opname for op in tmod.graph.ops
               if op.opname.startswith("kokkos.page_")]
    assert lowered == ([op.opname for op in jmod.graph.ops
                        if op.opname.startswith("kokkos.page_")])


def _ids_normalized(text):
    ids = {}
    return re.sub(r"%(\d+)", lambda m: "%" + ids.setdefault(
        m.group(1), f"v{len(ids)}"), text)


@pytest.mark.parametrize("demo", ["paged", "paged_swap"])
@pytest.mark.parametrize("target", [("loops", "loops"), ("xla", "torch"),
                                    ("pallas", "cuda")],
                         ids=["loops", "library", "kernels"])
def test_analyze_reports_what_the_reference_reports(demo, target, capsys):
    jtarget, ttarget = target
    assert jpipe.main(["--demo", demo, "--target", jtarget,
                       "--analyze"]) == 0
    ref = capsys.readouterr().out
    assert tpipe.main(["--demo", demo, "--target", ttarget, "--device",
                       "cpu", "--analyze"]) == 0
    got = capsys.readouterr().out
    assert got.replace(f"target={ttarget}", f"target={jtarget}") == ref
    assert "checks: dialect, race, sync, scratch, paged-alias" in got


def test_unforked_shared_write_is_rejected_as_in_the_reference():
    """check_paged_alias on a traced step: an append into a declared
    shared block without a fork first is an error in both packages, with
    the same diagnostics; forking first is clean."""
    bs, heads, hd, nb, slots, mb = 4, 2, 8, 8, 2, 3
    shapes = [((nb, heads, bs, hd), "float32"), ((slots, mb), "int32"),
              ((slots,), "int32"), ((slots, heads, hd), "float32"),
              ((1,), "int32"), ((1,), "int32")]

    def steps(o):
        def bad(pool, tab, ln, kv, src, dst):
            return o.page_append(pool, tab, ln, kv, block_size=bs,
                                 shared_block_ids=(2,))

        def good(pool, tab, ln, kv, src, dst):
            pool = o.page_copy(pool, pool, src, dst, block_size=bs,
                               fork_block_ids=(2,))
            return o.page_append(pool, tab, ln, kv, block_size=bs,
                                 shared_block_ids=(2,))
        return bad, good

    jbad, jgood = steps(jops)
    tbad, tgood = steps(tops)
    jspecs = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    tspecs = [TensorSpec(s, d) for s, d in shapes]
    with pytest.raises(janalysis.AnalysisError) as jerr:
        jpipe.compile(jbad, *jspecs, options=JOptions(target="xla",
                                                      verify_ir="full"))
    with pytest.raises(tanalysis.AnalysisError) as terr:
        tpipe.compile(tbad, *tspecs, options=TOptions(
            target="torch", device="cpu", verify_ir="full"))
    assert [_ids_normalized(d.format()) for d in terr.value.diagnostics] \
        == [_ids_normalized(d.format()) for d in jerr.value.diagnostics]
    assert any(d.checker == "paged-alias" for d in terr.value.diagnostics)
    mod = tpipe.compile(tgood, *tspecs, options=TOptions(
        target="torch", device="cpu", verify_ir="full"))
    assert not [d for d in getattr(mod.graph, "diagnostics", ())
                if d.severity == "error"]
    dump = mod.print_ir()
    assert "shared_block_ids" in dump and "fork_block_ids" in dump


def test_gather_wrapper_never_takes_the_plain_version_off_the_cpu():
    """On a non-CPU device (``meta`` standing in for a card) the gather
    launches or raises; it never runs its plain version."""
    pool = torch.zeros((5, 2, 4, 8), device="meta")
    table = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    lengths = torch.zeros((2,), dtype=torch.int32, device="meta")
    _reset_counts()
    with pytest.raises(ValueError):
        tpk.page_gather(pool, table, lengths, block_size=4)
    with pytest.raises(ValueError):      # mixed devices
        tpk.page_gather(pool, torch.zeros((2, 3), dtype=torch.int32),
                        lengths, block_size=4)
    assert tpk.page_gather.plain_calls == 0


def test_paged_kernel_sources_and_registrations():
    from repro_torch.core import backend
    fn, specs, _ = tpipe._demo_paged()
    mod = tpipe.compile(fn, *specs, options=TOptions(target="cuda",
                                                     device="cpu"))
    assert [ks.name for ks in kops.kernel_sources(mod.graph)] == \
        ["page_gather"]
    cuda = backend.get_backend("cuda")
    assert "kokkos.page_gather" in cuda.registered_ops()
    # no hand append or copy: the fallback chain serves them from torch
    for op in ("kokkos.page_append", "kokkos.page_copy"):
        assert cuda.kernel(op) is None
        assert cuda.select_impl(op, TOptions(target="cuda",
                                             device="cpu")) == "torch"
    loops = backend.get_backend("loops")
    assert loops.kernel("kokkos.page_gather") is tpk.page_gather_loops
