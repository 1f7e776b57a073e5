"""The port's passes, dialect, IR and tracer held to the JAX reference on
the CPU.

The cases of the reference's ``tests/test_passes.py``,
``tests/test_kokkos_dialect.py``, ``tests/test_ir.py`` and
``tests/test_tracer.py``, each run through ``repro`` (JAX) and
``repro_torch`` (``device="cpu"``) on the same seeded inputs: IR dumps
equal once SSA ids are renumbered, fusion and DualView statistics equal,
results within 1e-5 in f32.  Where the reference pins a TPU choice the
port case pins the port's H100 choice and says so; the reference then
runs under the H100's hierarchy too and must decide the same.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from test_torch_analysis import (F32, HIERS, PORT, REF,  # noqa: E402
                                 ids_normalized)

_TOL = dict(rtol=1e-5, atol=1e-5)


def _ir(graph) -> str:
    return ids_normalized(str(graph))


def _names(graph) -> list:
    return [op.opname for op in graph.ops]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_ref(case):
    """``case(P)`` in each package → (port's, reference's)."""
    return case(PORT), case(REF)


# ---------------------------------------------------------------------------
# tests/test_passes.py
# ---------------------------------------------------------------------------

def test_linalg_to_library_rewrites_matmul():
    def case(P):
        g = P.trace(lambda x, y: P.ops.matmul(x, y), (3, 4), (4, 5))
        return P.passes.linalg_to_library(g), _names(g), _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[:2] == (1, ["kk.gemm"])


def test_fusion_chains_single_use():
    def case(P):
        ops = P.ops
        g = P.trace(lambda x: ops.mul(ops.relu(ops.add(x, x)),
                                      ops.sigmoid(x)), (4, 8))
        with P.options.use_options(P.opts(fuse_elementwise=True)):
            n = P.passes.fuse_elementwise(g)
        g.dce()
        return n, _names(g), _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0] >= 2 and port[1].count("kokkos.fused") == 1


def test_fusion_respects_multi_use():
    def case(P):
        ops = P.ops

        def fn(x):
            h = ops.relu(x)          # two consumers: must not fuse into one
            return ops.add(h, ops.sigmoid(h))
        g = P.trace(fn, (4, 8))
        with P.options.use_options(P.opts(fuse_elementwise=True)):
            n = P.passes.fuse_elementwise(g)
        return n, _names(g), _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert "linalg.relu" in port[1]


def _gemm_tiling(P, target, hierarchy=None):
    g = P.trace(lambda x, y: P.ops.matmul(x, y), (300, 700), (700, 900))
    P.passes.linalg_to_library(g)
    with P.options.use_options(P.opts(target, hierarchy=hierarchy)):
        P.passes.map_parallelism(g)
    return g.ops[0].attrs["tiling"], g.ops[0].attrs["level_map"]


def test_map_parallelism_gemm_heuristics_compute_unit_aligned():
    """The reference pins MXU-aligned blocks (128) on ``grid × block ×
    lane``; the port's H100 choice is ``compute_unit`` (64) aligned on
    ``grid × block × warp``, and the reference decides the same blocks
    under the H100's hierarchy."""
    h = PORT.backend.H100_HIERARCHY
    t, level_map = _gemm_tiling(PORT, "cuda")
    assert t["bn"] % h.compute_unit == 0 and t["bk"] % h.compute_unit == 0
    assert t["bm"] % h.team_width == 0
    fp = (t["bm"] * t["bk"] + t["bk"] * t["bn"]) * 4 + t["bm"] * t["bn"] * 4
    assert fp <= h.scratch_bytes
    assert level_map == ("grid", "block", "warp")
    assert _gemm_tiling(REF, "cuda", HIERS["h100"]) == (t, level_map)
    # and the port under the TPU's hierarchy decides the reference's
    ref_t, ref_map = _gemm_tiling(REF, "cuda")
    assert ref_t["bn"] % 128 == 0 and ref_map == ("grid", "block", "lane")
    assert _gemm_tiling(PORT, "cuda", HIERS["tpu"]) == (ref_t, ref_map)


def test_spmv_vector_length_heuristic():
    """paper §4.2: vector length = ceil(avg nnz/row), clamped to the
    declared vector width — the TPU's lane (128) in the reference, the
    H100's warp (32) in the port."""
    def case(P, hier):
        h = P.hier(HIERS[hier])
        return (P.passes.choose_spmv_tiling(10000, nnz_mean=14.3, hier=h),
                P.passes.choose_spmv_tiling(10000, nnz_mean=5000.0, hier=h))
    for hier in HIERS:
        assert case(PORT, hier) == case(REF, hier)
    t, t2 = case(PORT, "h100")
    assert t["row_width"] == 16
    assert t2["row_width"] == PORT.backend.H100_HIERARCHY.vector_width == 32
    assert case(PORT, "tpu")[1]["row_width"] == 128


def test_spmv_row_width_clamped_to_declared_vector_width():
    def case(P):
        LevelSpec, PH = P.backend.LevelSpec, P.backend.ParallelHierarchy
        out = []
        for warp in (32, 64, 128):
            hier = PH(exec_space="device",
                      levels=(LevelSpec("blockIdx"),
                              LevelSpec("warp", width=8),
                              LevelSpec("thread", width=warp,
                                        max_extent=1024)),
                      scratch_bytes=48 * 2**10, compute_unit=16)
            t = P.passes.choose_spmv_tiling(4096, nnz_mean=10 * warp,
                                            hier=hier)
            assert t["row_width"] == warp
            small = P.passes.choose_spmv_tiling(4096, nnz_mean=9.0,
                                                hier=hier)
            assert small["row_width"] == 16
            out += [t, small]
        narrow = PH(exec_space="device",
                    levels=(LevelSpec("blockIdx"),
                            LevelSpec("thread", width=4),),
                    scratch_bytes=48 * 2**10, compute_unit=16)
        t = P.passes.choose_spmv_tiling(4096, nnz_mean=100.0, hier=narrow)
        assert t["row_width"] == 8
        return out + [t]
    port, ref = _port_ref(case)
    assert port == ref


def test_parallel_lowering_is_backend_neutral():
    for target in ("torch", "cuda", "loops"):
        def case(P):
            g = P.trace(lambda x: P.ops.relu(x), (64, 256))
            with P.options.use_options(P.opts(target)):
                assert P.passes.linalg_to_parallel(g) == 1
            return _ir(g), tuple(lv.name for lv in g.ops[0].attrs["nest"])
        port, ref = _port_ref(case)
        assert port == ref
        assert "kokkos.team_parallel" in port[0]
        assert port[1] == ("team", "vector")


def _mapped_relu(P, target, hierarchy=None):
    g = P.trace(lambda x: P.ops.relu(x), (64, 256))
    with P.options.use_options(P.opts(target, hierarchy=hierarchy)):
        P.passes.linalg_to_parallel(g)
        P.passes.map_parallelism(g)
    return g


def test_map_parallelism_binds_nest_per_backend():
    """The reference binds ``("block", "lane")`` on ``pallas``; the port's
    ``cuda`` binds the H100's ``("block", "warp")`` with blocks a whole
    number of warps wide.  Library backends collapse the nest."""
    op = _mapped_relu(PORT, "cuda").ops[0]
    assert op.opname == "kokkos.team_parallel"
    assert op.attrs["level_map"] == ("block", "warp")
    assert op.attrs["exec_space"] == "device"
    assert op.attrs["tiling"]["block"][-1] % 32 == 0
    for hier in HIERS:
        assert _ir(_mapped_relu(PORT, "cuda", HIERS[hier])) == \
            _ir(_mapped_relu(REF, "cuda", HIERS[hier]))

    op2 = _mapped_relu(PORT, "torch").ops[0]
    assert op2.attrs["collapse"] and op2.attrs["level_map"] == \
        ("fused", "fused")
    assert "tiling" not in op2.attrs
    assert _ir(_mapped_relu(PORT, "torch")) == _ir(_mapped_relu(REF,
                                                                "torch"))


def _two_use_constant(P, rng_seed=0):
    w = np.random.default_rng(rng_seed).standard_normal(
        (8, 8)).astype(np.float32)

    def fn(x):
        c = P.ops.constant(w)
        return P.ops.matmul(P.ops.matmul(x, c), c)   # two uses of one constant
    g = P.trace(fn, (8, 8))
    P.passes.linalg_to_library(g)
    return g


def test_dualview_pass_lazy_sync_once():
    def case(P):
        g = _two_use_constant(P)
        n = P.passes.memory_space_management(g)
        syncs = [o for o in g.ops if o.opname == "kokkos.sync"]
        return n, len(syncs), _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0] == port[1] == 1          # lazy: one sync per buffer


def test_dualview_pass_eager_mode_syncs_every_use():
    def case(P):
        g = _two_use_constant(P)
        with P.options.use_options(P.opts(lazy_dualview=False)):
            n = P.passes.memory_space_management(g)
        spaces = [o.attrs.get("space") for o in g.ops
                  if o.opname == "kokkos.sync"]
        return n, spaces.count("device"), spaces.count("host_roundtrip"), \
            _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[1:3] == (2, 2)     # per-use h2d, per-kernel d2h round-trips


def test_full_pipeline_stats():
    def case(P):
        ops = P.ops
        g = P.trace(lambda x, y: ops.softmax(ops.matmul(ops.relu(x), y)),
                    (16, 32), (32, 64))
        P.passes.run_pipeline(g, P.opts("torch", hierarchy=HIERS["h100"]))
        assert [s.name for s in g.pass_stats] == list(g.pipeline_stats)
        assert all(s.seconds >= 0 for s in g.pass_stats)
        return dict(g.pipeline_stats), [
            (s.name, s.rewrites, s.ops_before, s.ops_after)
            for s in g.pass_stats], _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0]["linalg_to_library"] == 1


# worklist fusion ≡ the seed's restart-scan (identical fusion counts)

def _restart_scan_fusion(P, graph):
    """The reference's oracle: re-walk the op list from the top after
    every single fusion."""
    passes = P.passes
    fused = 0
    changed = True
    while changed:
        changed = False
        users = graph.users()
        for op in graph.ops:
            if op.opname not in passes._FUSABLE:
                continue
            uses = users.get(op.results[0].id, [])
            if len(uses) != 1:
                continue
            user_op, operand_idx = uses[0]
            if user_op is None or user_op.opname not in passes._FUSABLE:
                continue
            if user_op.results[0].shape != op.results[0].shape:
                continue
            passes._fuse_pair(graph, op, user_op, operand_idx)
            fused += 1
            changed = True
            break
    return fused


_FUSION_GRAPHS = {
    "chain+sidechain": lambda o: lambda x: o.mul(o.relu(o.add(x, x)),
                                                 o.sigmoid(x)),
    "multi-use": lambda o: lambda x: o.add(o.relu(x), o.sigmoid(o.relu(x))),
    "long-chain": lambda o: lambda x: o.relu(o.sigmoid(o.tanh(o.exp(
        o.neg(x))))),
    "two-chains": lambda o: lambda x: o.mul(o.relu(o.neg(x)),
                                            o.tanh(o.exp(x))),
}


@pytest.mark.parametrize("name", list(_FUSION_GRAPHS))
def test_worklist_fusion_count_matches_restart_scan(name):
    def case(P):
        fn = _FUSION_GRAPHS[name](P.ops)
        with P.options.use_options(P.opts(fuse_elementwise=True)):
            g_new = P.trace(fn, (4, 8))
            n_new = P.passes.fuse_elementwise(g_new)
            g_ref = P.trace(fn, (4, 8))
            n_ref = _restart_scan_fusion(P, g_ref)
        assert n_new == n_ref
        g_new.dce()
        g_ref.dce()
        assert sorted(_names(g_new)) == sorted(_names(g_ref))
        return n_new, _ir(g_new)
    port, ref = _port_ref(case)
    assert port == ref


def test_fused_op_carries_structured_region():
    def case(P):
        ops = P.ops
        g = P.trace(lambda x: ops.relu(ops.sigmoid(ops.tanh(ops.add(x, x)))),
                    (4, 8))
        with P.options.use_options(P.opts(fuse_elementwise=True)):
            P.passes.fuse_elementwise(g)
        g.dce()
        (fused,) = [o for o in g.ops if o.opname == "kokkos.fused"]
        region = fused.regions[0]
        assert [s.opname for s in region.ops] == [
            "linalg.add", "linalg.tanh", "linalg.sigmoid", "linalg.relu"]
        assert fused.attrs["ops"] == tuple(s.opname for s in region.ops)
        assert len(region.inputs) == len(fused.operands)
        visible = {v.id for v in region.inputs}
        for sub in region.ops:
            assert all(o.id in visible for o in sub.operands)
            visible.update(r.id for r in sub.results)
        assert region.outputs[0] is region.ops[-1].results[0]
        assert not any(callable(v) for v in fused.attrs.values())
        dump = str(g)
        assert "kokkos.fused" in dump and "yield" in dump
        assert "linalg.tanh" in dump
        return _ir(g)
    port, ref = _port_ref(case)
    assert port == ref


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_fused_region_lowers_to_one_nest_and_scratch_intermediates(hier):
    def case(P):
        ops = P.ops
        g = P.trace(lambda x: ops.relu(ops.sigmoid(ops.tanh(ops.add(x, x)))),
                    (64, 128))
        with P.options.use_options(P.opts("cuda",
                                          hierarchy=HIERS[hier])) as o:
            P.passes.run_pipeline(g, o)
        nests = [op for op in g.ops if op.opname in P.ir.KOKKOS_PARALLEL_OPS]
        assert len(nests) == 1
        (nest,) = nests
        assert nest.regions and nest.attrs["src"] == "kokkos.fused"
        for sub in nest.regions[0].ops[:-1]:
            assert sub.results[0].type.memory_space is \
                P.ir.MemorySpace.SCRATCH
        assert nest.attrs["tiling"]["block"]
        assert g.pipeline_stats["fuse_elementwise"] == 3
        return _ir(g), dict(g.pipeline_stats)
    port, ref = _port_ref(case)
    assert port == ref


def test_fused_region_footprint_counts_intermediates():
    tiny = {"exec_space": "device",
            "levels": [{"name": "grid"}, {"name": "block", "width": 8},
                       {"name": "lane", "width": 8, "max_extent": 64}],
            "scratch_bytes": 2**14, "compute_unit": 8}

    def case(P):
        ops = P.ops
        fns = {"chain": lambda x: ops.relu(ops.sigmoid(ops.tanh(
            ops.add(x, x)))), "one": lambda x: ops.relu(x)}
        blocks = {}
        for name, fn in fns.items():
            g = P.trace(fn, (256, 256))
            with P.options.use_options(P.opts("cuda", hierarchy=tiny)) as o:
                P.passes.run_pipeline(g, o)
            (nest,) = [op for op in g.ops
                       if op.opname == "kokkos.team_parallel"]
            blocks[name] = nest.attrs["tiling"]["block"]
        assert np.prod(blocks["chain"]) <= np.prod(blocks["one"])
        return blocks
    port, ref = _port_ref(case)
    assert port == ref


def _shrink_hierarchies():
    serial = PORT.backend.get_backend("loops").hierarchy.to_dict()
    gpu = {"exec_space": "device",
           "levels": [{"name": "blockIdx"}, {"name": "warp", "width": 32},
                      {"name": "thread", "width": 32, "max_extent": 1024}],
           "scratch_bytes": 48 * 2**10, "compute_unit": 16}
    return {"tpu": HIERS["tpu"], "serial": serial, "gpu": gpu,
            "tight-tpu": dict(HIERS["tpu"], scratch_bytes=2**16),
            "h100": HIERS["h100"]}


SHRINK = _shrink_hierarchies()


@pytest.mark.parametrize("hname", sorted(SHRINK))
@pytest.mark.parametrize("m,n,k", [
    (24, 24, 24), (7, 513, 129), (300, 700, 900), (1, 1, 1),
    (1023, 65, 4097), (24, 8, 8)])
def test_matmul_blocks_stay_width_aligned(hname, m, n, k):
    """The scratch-shrink loop keeps the team / vector alignment, on the
    reference's four hierarchies and the H100's; both packages decide
    the same blocks."""
    hier = PORT.hier(SHRINK[hname])
    t = PORT.passes.choose_matmul_blocks(m, n, k, itemsize=4, hier=hier)
    assert t == REF.passes.choose_matmul_blocks(
        m, n, k, itemsize=4, hier=REF.hier(SHRINK[hname]))
    bm, bn, bk = t["bm"], t["bn"], t["bk"]
    assert bm % hier.team_width == 0 and bm >= hier.team_width
    assert bn % hier.vector_width == 0 and bn >= hier.vector_width
    assert bk % hier.vector_width == 0 and bk >= hier.vector_width
    fp = (bm * bk + bk * bn) * 4 + bm * bn * 4
    if fp > hier.scratch_bytes // 2:
        assert bk <= hier.compute_unit or bk == hier.vector_width
        assert bm < bn or bm == hier.team_width
        assert bn == hier.vector_width


def test_worklist_fusion_preserves_semantics():
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)

    def case(P):
        ops = P.ops

        def fn(v):
            return ops.mul(ops.relu(ops.add(v, v)), ops.sigmoid(v))
        with P.options.use_options(P.opts(fuse_elementwise=True)) as o:
            g = P.trace(fn, (4, 8))
            n = P.passes.fuse_elementwise(g)
            g.dce()
            assert n >= 2
            return _np(P.emitter.build_callable(g, o)(x))
    port, ref = _port_ref(case)
    expect = np.maximum(x + x, 0) * (1 / (1 + np.exp(-x)))
    np.testing.assert_allclose(port, expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port, ref, **_TOL)


# ---------------------------------------------------------------------------
# tests/test_kokkos_dialect.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,opname,names", [
    ((512,), "kokkos.range_parallel", ("range",)),
    ((64, 256), "kokkos.team_parallel", ("team", "vector")),
    ((4, 8, 16, 128), "kokkos.team_parallel",
     ("league", "league", "team", "vector")),
], ids=["depth1-range", "depth2-team", "depth4-league"])
def test_decision_table_nest_shapes(shape, opname, names):
    def case(P):
        g = P.trace(lambda x: P.ops.relu(x), shape)
        with P.options.use_options(P.opts("cuda")):
            assert P.passes.linalg_to_parallel(g) == 1
        op = g.ops[0]
        assert op.opname == opname
        nest = op.attrs["nest"]
        assert tuple(lv.name for lv in nest) == names
        assert tuple(lv.trip for lv in nest) == shape
        assert all(isinstance(lv, P.ir.LoopLevel) for lv in nest)
        return _ir(g)
    port, ref = _port_ref(case)
    assert port == ref


# the reference pins pallas's ("grid", "block", "lane"); the port's cuda
# pins the H100's ("grid", "block", "warp")
_EXPECT_DUMP = {
    "cuda": ("level_map=('grid', 'block', 'warp')", "exec_space='device'"),
    "loops": ("level_map=('serial', 'serial-block', 'jnp-vector')",
              "exec_space='host'"),
    "torch": ("level_map=('fused', 'fused', 'fused')", "collapse=True"),
}


@pytest.mark.parametrize("target", sorted(_EXPECT_DUMP))
def test_map_parallelism_ir_dump_per_backend(target):
    hier = PORT.backend.get_backend(target).hierarchy.to_dict()

    def case(P):
        g = P.trace(lambda x: P.ops.relu(x), (4, 16, 128))
        dumped = []
        pm = P.passmgr.PassManager(("linalg_to_parallel", "map_parallelism"),
                                   verify="full", print_ir_after_all=True,
                                   sink=dumped.append)
        with P.options.use_options(P.opts(target, hierarchy=hier)) as o:
            pm.run(g, o)
        return ids_normalized("\n".join(dumped))
    dump, ref = _port_ref(case)
    assert dump == ref
    assert "IR after map_parallelism" in dump
    assert "kokkos.team_parallel" in dump
    for needle in _EXPECT_DUMP[target]:
        assert needle in dump, (target, needle, dump)


def test_no_flat_tpu_ops_anywhere():
    for target in ("torch", "cuda", "loops"):
        def case(P):
            ops = P.ops
            g = P.trace(lambda x, y: ops.softmax(ops.matmul(ops.relu(x), y)),
                        (16, 32), (32, 64))
            hier = PORT.backend.get_backend(target).hierarchy.to_dict()
            with P.options.use_options(P.opts(target,
                                              hierarchy=hier)) as o:
                P.passes.run_pipeline(g, o)
            for op in g.ops:
                assert not op.opname.startswith("tpu."), op
            assert any(op.opname in P.ir.KOKKOS_PARALLEL_OPS
                       for op in g.ops)
            return _ir(g)
        port, ref = _port_ref(case)
        assert port == ref, target


def test_parallel_hierarchy_dict_round_trip():
    PH, LevelSpec = PORT.backend.ParallelHierarchy, PORT.backend.LevelSpec
    h = PH(exec_space="device",
           levels=(LevelSpec("blockIdx"), LevelSpec("warp", width=32),
                   LevelSpec("thread", width=32, max_extent=1024)),
           scratch_bytes=48 * 2**10, compute_unit=16)
    assert PH.from_dict(h.to_dict()) == h
    h100 = PORT.backend.H100_HIERARCHY
    assert PH.from_dict(h100.to_dict()) == h100
    for name in PORT.backend.available_backends():
        declared = PORT.backend.get_backend(name).hierarchy
        assert PH.from_dict(declared.to_dict()) == declared
    # the dicts are the reference's format: each package reads the other's
    assert REF.hier(h100.to_dict()).to_dict() == h100.to_dict()
    tpu = REF.backend.TPU_HIERARCHY
    assert PORT.hier(tpu.to_dict()).to_dict() == tpu.to_dict()


def test_map_levels_binding():
    """The reference binds the TPU's lanes; the port's H100 record binds
    warps innermost, the same way."""
    h = PORT.backend.H100_HIERARCHY
    assert h.map_levels(("league", "team", "vector")) == \
        ("grid", "block", "warp")
    assert h.map_levels(("team", "vector")) == ("block", "warp")
    assert h.map_levels(("vector",)) == ("warp",)
    assert h.map_levels(("league", "league", "team", "vector")) == \
        ("grid", "grid", "block", "warp")
    assert PORT.backend.ParallelHierarchy().map_levels(
        ("team", "vector")) == ("fused", "fused")
    for logical in (("league", "team", "vector"), ("team", "vector"),
                    ("vector",), ("league", "league", "team", "vector")):
        for d in HIERS.values():
            assert PORT.hier(d).map_levels(logical) == \
                REF.hier(d).map_levels(logical)


def test_depth0_hierarchy_on_loop_backend_compiles():
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)

    def case(P):
        opts = P.opts("loops", fuse_elementwise=False,
                      hierarchy={"exec_space": "host"})
        return _np(P.pipeline.compile(lambda a: P.ops.relu(a),
                                      P.spec((8, 32), F32),
                                      options=opts)(x))
    port, ref = _port_ref(case)
    np.testing.assert_allclose(port, np.maximum(x, 0))
    np.testing.assert_array_equal(port, ref)


def test_options_hierarchy_override_wins():
    narrow = {"exec_space": "device",
              "levels": [{"name": "grid"},
                         {"name": "block", "width": 8, "max_extent": 8},
                         {"name": "warp", "width": 16, "max_extent": 16}],
              "scratch_bytes": 2**16, "compute_unit": 16}

    def case(P):
        g = _mapped_relu(P, "cuda", narrow)
        block = g.ops[0].attrs["tiling"]["block"]
        assert block[-1] <= 16 and block[-2] <= 8
        return _ir(g)
    port, ref = _port_ref(case)
    assert port == ref


def test_backends_agree_on_nested_parallel_workload():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 64), dtype=np.float32)
    x = rng.standard_normal((4, 16, 128)).astype(np.float32)

    def run(P, target):
        ops = P.ops

        def fn(v):
            h = ops.relu(v)                       # league+team+vector nest
            s = ops.softmax(h)                    # reduce nest (vector axis)
            return ops.matmul(ops.mul(s, h), ops.constant(w))   # kk.gemm
        opts = P.opts(target, fuse_elementwise=False)
        return _np(P.pipeline.compile(fn, P.spec((4, 16, 128), F32),
                                      options=opts)(x))
    y_ref = run(REF, "torch")
    y_lib = run(PORT, "torch")
    np.testing.assert_allclose(y_lib, y_ref, **_TOL)
    np.testing.assert_allclose(run(PORT, "loops"), y_lib, **_TOL)
    np.testing.assert_allclose(run(PORT, "cuda"), y_lib, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_ir.py
# ---------------------------------------------------------------------------

def _g(P):
    ir = P.ir
    t = ir.TensorType((4, 4), F32)
    a, b = ir.Value(t, name="a"), ir.Value(t, name="b")
    g = ir.Graph("f", inputs=[a, b])
    add = g.add(ir.Op("linalg.add", [a, b], [t]))
    mul = g.add(ir.Op("linalg.mul", [add.results[0], b], [t]))
    g.outputs = [mul.results[0]]
    return g, a, b, add, mul


def test_types():
    def case(P):
        ir = P.ir
        t = ir.TensorType((2, 3), F32, ir.MemorySpace.DUAL)
        assert t.with_space(ir.MemorySpace.SCRATCH).memory_space is \
            ir.MemorySpace.SCRATCH
        return str(t), t.nbytes
    port, ref = _port_ref(case)
    assert port == ref
    assert "2x3xfloat32" in port[0] and "#dual" in port[0]
    assert port[1] == 24


def test_walk_and_users():
    def case(P):
        g, a, b, add, mul = _g(P)
        users = g.users()
        return ([op.opname for op in g.walk()],
                len(users[add.results[0].id]), len(users[b.id]))
    port, ref = _port_ref(case)
    assert port == ref == (["linalg.add", "linalg.mul"], 1, 2)


def test_replace_op_rewires():
    def case(P):
        g, a, b, add, mul = _g(P)
        sub = P.ir.Op("linalg.sub", [a, b], [add.results[0].type])
        g.replace_op(add, [sub], {add.results[0]: sub.results[0]})
        assert mul.operands[0] is sub.results[0]
        assert g.ops[0] is sub
        return _ir(g)
    port, ref = _port_ref(case)
    assert port == ref


def test_dce_removes_dead_keeps_side_effects():
    def case(P):
        g, a, b, add, mul = _g(P)
        dead = g.add(P.ir.Op("linalg.neg", [a], [add.results[0].type]))
        sync = g.add(P.ir.Op("kokkos.sync", [a], []))
        removed = g.dce()
        assert dead not in g.ops and sync in g.ops
        return removed, _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0] == 1


def test_print_roundtrip_contains_structure():
    s, ref = _port_ref(lambda P: _ir(_g(P)[0]))
    assert s == ref
    assert "func @f" in s and "linalg.add" in s and "return" in s


def test_nbytes_bf16_is_two_bytes_per_elem():
    def case(P):
        ir = P.ir
        return (ir.TensorType((128, 256), "bf16").nbytes,
                ir.TensorType((128, 256), F32).nbytes,
                ir.TensorType((8,), "bfloat16").nbytes)
    port, ref = _port_ref(case)
    assert port == ref == (128 * 256 * 2, 128 * 256 * 4, 16)


# ---------------------------------------------------------------------------
# tests/test_tracer.py
# ---------------------------------------------------------------------------

def test_trace_shapes_and_ops():
    def case(P):
        ops = P.ops
        g = P.trace(lambda x, y: ops.softmax(ops.matmul(ops.relu(x), y)),
                    (3, 5), (5, 7))
        return _names(g), g.outputs[0].shape, _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[:2] == (["linalg.relu", "linalg.matmul", "linalg.softmax"],
                        (3, 7))


def test_constants_lifted_and_cached():
    w = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)

    def case(P):
        ops = P.ops

        def fn(x):
            return ops.matmul(x, ops.constant(w)) + ops.matmul(
                x, ops.constant(w))
        g = P.trace(fn, (2, 4))
        return len([op for op in g.ops if op.opname == "tensor.constant"]), \
            _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0] == 1                  # cached by id


def test_operator_sugar():
    def case(P):
        g = P.trace(lambda x: (-x + x * 2.0).sum(axis=1), (2, 4))
        return g.outputs[0].shape, _ir(g)
    port, ref = _port_ref(case)
    assert port == ref
    assert port[0] == (2,)


def test_eager_mode_matches_traced():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((8, 3)).astype(np.float32)

    def fn_of(ops):
        def fn(a):
            return ops.softmax(ops.matmul(ops.gelu(a), ops.constant(w)))
        return fn
    eager = fn_of(PORT.ops)(torch.from_numpy(x))   # no trace: direct execution
    mod = PORT.pipeline.compile(fn_of(PORT.ops), PORT.spec((4, 8), F32),
                                options=PORT.opts("auto"))
    traced = mod(x).numpy()
    np.testing.assert_allclose(traced, eager.numpy(), **_TOL)
    ref_eager = np.asarray(fn_of(REF.ops)(jnp.asarray(x)))
    np.testing.assert_allclose(eager.numpy(), ref_eager, **_TOL)


def test_dataclass_options_match_the_reference():
    """Every option the port's compiler shares with the reference keeps
    the reference's default; the port drops only the JAX-only fields
    and adds ``device``."""
    ref = {f.name: f.default for f in dataclasses.fields(
        REF.options.CompileOptions)}
    port = {f.name: f.default for f in dataclasses.fields(
        PORT.options.CompileOptions)}
    assert set(ref) - set(port) == {"interpret", "embed_constants",
                                    "donate_buffers"}
    assert set(port) - set(ref) == {"device"}
    assert {k: v for k, v in port.items() if k in ref} == \
        {k: v for k, v in ref.items() if k in port}
