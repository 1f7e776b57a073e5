"""The port's roofline cost model held to the JAX reference on the CPU.

The cases of the reference's ``tests/test_costmodel.py`` that
``tests/test_torch_autotune.py`` does not hold already: machine peaks
(defaults, round trip, a corrupt file, declared ceilings against
inherited host peaks), the fusion gate on library and dispatch
backends, the ranked tilings against the scratch budget on the
reference's hierarchies and the H100's, the SpMV candidates, stable
ranking and the roofline's shape.  Both packages rank the same
candidates in the same order with the same predictions.

The conftest's autouse fixture points ``REPRO_TUNE_CACHE`` at a fresh
directory, so every test starts with no persisted peaks.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_analysis import HIERS, PORT, REF  # noqa: E402

cm = PORT.costmodel


# ---------------------------------------------------------------------------
# machine peaks — persistence + resolution
# ---------------------------------------------------------------------------

def test_default_peaks_until_measured():
    peaks = cm.load_peaks()
    assert not peaks.measured
    assert peaks.bandwidth_bytes_per_s == \
        cm.DEFAULT_PEAKS["bandwidth_bytes_per_s"]
    assert peaks.fingerprint == cm.machine_fingerprint()


def test_host_default_peaks_are_the_references():
    """The host defaults are the reference's numbers (20 GB/s streaming,
    50 GFLOP/s, 5 µs a launch); the port adds only the bf16 matrix rate
    the dry-run divides by, at the f32 default."""
    ref = REF.costmodel.DEFAULT_PEAKS
    port = dict(cm.DEFAULT_PEAKS)
    assert port.pop("bf16_flops_per_s") == port["flops_per_s"]
    assert port == ref
    assert port["bandwidth_bytes_per_s"] == 2.0e10


def test_peaks_round_trip():
    measured = cm.MachinePeaks(
        bandwidth_bytes_per_s=1.5e10, scratch_bandwidth_bytes_per_s=9e10,
        flops_per_s=7e10, bf16_flops_per_s=9e11, launch_overhead_s=3e-6,
        dispatch_overhead_s=8e-6, fingerprint=cm.machine_fingerprint(),
        measured=True)
    path = cm.save_peaks(measured)
    assert cm.load_peaks() == measured
    record = json.load(open(path))
    assert record["measured"] is True
    # the record holds every field of the reference's
    assert {f.name for f in dataclasses.fields(
        REF.costmodel.MachinePeaks)} <= set(record)


def test_corrupt_peaks_file_falls_back_to_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    p = tmp_path / f"machine_peaks_{cm.machine_fingerprint()}.json"
    p.write_text("{not json")
    assert not cm.load_peaks().measured


def test_declared_hierarchy_ceilings_win_over_peaks():
    h = PORT.backend.H100_HIERARCHY
    model = cm.CostModel(h)
    assert model.bandwidth == h.bandwidth_bytes_per_s == 3.35e12
    assert model.flops == h.flops_per_s == 6.7e13
    assert model.launch_overhead == h.launch_overhead_s == 4.0e-6
    for d in HIERS.values():
        ref, port = REF.costmodel.CostModel(REF.hier(d)), \
            cm.CostModel(PORT.hier(d))
        assert (port.bandwidth, port.flops, port.launch_overhead) == \
            (ref.bandwidth, ref.flops, ref.launch_overhead)


def test_undeclared_hierarchy_inherits_host_peaks():
    serial = PORT.backend.get_backend("loops").hierarchy
    model = cm.CostModel(serial)
    assert model.bandwidth == cm.DEFAULT_PEAKS["bandwidth_bytes_per_s"]
    # 0.0 is a *declaration*, not a missing value
    assert model.launch_overhead == 0.0
    assert serial.to_dict() == REF.backend.get_backend(
        "loops").hierarchy.to_dict()


def test_hierarchy_perf_fields_dict_round_trip():
    PH = PORT.backend.ParallelHierarchy
    h = dataclasses.replace(PORT.backend.H100_HIERARCHY)
    assert PH.from_dict(h.to_dict()) == h
    bare = PH()
    assert "bandwidth_bytes_per_s" not in bare.to_dict()
    assert PH.from_dict(bare.to_dict()) == bare


# ---------------------------------------------------------------------------
# the fusion gate
# ---------------------------------------------------------------------------

def _edge_ops(P, shape=(256, 512)):
    ir = P.ir
    t = ir.TensorType(shape, "f32")
    x = ir.Value(t)
    producer = ir.Op("linalg.relu", [x], [t])
    consumer = ir.Op("linalg.tanh", [producer.results[0]], [t])
    return producer, consumer


def test_fusion_gate_rejects_on_jit_traced_backends():
    """launch_overhead_s=0.0 (the loops hierarchy, in both packages)
    means op boundaries are not dispatched: fusing saves nothing."""
    for name in ("loops", "openmp"):
        h = PORT.backend.get_backend(name).hierarchy
        assert not cm.CostModel(h).fusion_gate(*_edge_ops(PORT))


def test_fusion_gate_accepts_on_real_dispatch_backends():
    for name in ("cuda", "torch", "auto"):
        h = PORT.backend.get_backend(name).hierarchy
        assert cm.CostModel(h).fusion_gate(*_edge_ops(PORT))


def test_torch_backend_declares_a_real_launch_overhead():
    """A difference, pinned: the reference's library backends declare
    ``launch_overhead_s=0.0`` because XLA jits their ops into one
    program; the port's ``torch`` and ``auto`` run every op eagerly, a
    CUDA launch each on the card, so they keep the H100's 4 µs and the
    fusion gate fuses there."""
    for port_name, ref_name in (("torch", "xla"), ("auto", "auto")):
        ph = PORT.backend.get_backend(port_name).hierarchy
        rh = REF.backend.get_backend(ref_name).hierarchy
        assert ph.launch_overhead_s == 4.0e-6 and ph == \
            PORT.backend.H100_HIERARCHY
        assert rh.launch_overhead_s == 0.0
        assert cm.CostModel(ph).fusion_gate(*_edge_ops(PORT))
        assert not REF.costmodel.CostModel(rh).fusion_gate(*_edge_ops(REF))


def _chain(ops):
    def chain(x):
        h = x
        for f in (ops.tanh, ops.relu, ops.sigmoid, ops.neg, ops.relu):
            h = f(h)
        return h
    return chain


def test_cost_gated_pipeline_matches_unfused_on_loops():
    x = np.random.default_rng(0).standard_normal((64, 128)) \
        .astype(np.float32)

    def compile_(P, **kw):
        return P.pipeline.compile(_chain(P.ops), x,
                                  options=P.opts("loops", **kw))
    unfused = compile_(PORT, fuse_elementwise=False, cost_model=True)
    gated = compile_(PORT, cost_model=True)
    fused = compile_(PORT)
    assert gated.launch_count == unfused.launch_count
    assert fused.launch_count < unfused.launch_count
    assert gated.emit_cpp_source() == unfused.emit_cpp_source()
    np.testing.assert_allclose(gated(x).numpy(), unfused(x).numpy(),
                               rtol=1e-6)
    # the loops unit is the reference's, byte for byte
    assert gated.emit_cpp_source() == compile_(
        REF, cost_model=True).emit_cpp_source()


@pytest.mark.parametrize("target", ["cuda", "torch"])
def test_cost_gate_still_fuses_on_device_hierarchy(target):
    x = np.random.default_rng(0).standard_normal((8, 128)) \
        .astype(np.float32)

    def chain(x):
        return PORT.ops.relu(PORT.ops.tanh(PORT.ops.sigmoid(x)))
    gated = PORT.pipeline.compile(chain, x, options=PORT.opts(
        target, cost_model=True))
    fused = PORT.pipeline.compile(chain, x, options=PORT.opts(target))
    assert gated.launch_count == fused.launch_count
    assert any(op.opname == "kokkos.team_parallel" and op.regions
               for op in gated.graph.ops)


# ---------------------------------------------------------------------------
# candidate generators + model ranking (property tests)
# ---------------------------------------------------------------------------

def _hierarchies():
    serial = PORT.backend.get_backend("loops").hierarchy.to_dict()
    gpu = {"exec_space": "device",
           "levels": [{"name": "blockIdx"}, {"name": "warp", "width": 32},
                      {"name": "thread", "width": 32, "max_extent": 1024}],
           "scratch_bytes": 48 * 2**10, "compute_unit": 16}
    return {"tpu": HIERS["tpu"], "serial": serial, "gpu": gpu,
            "tight-tpu": dict(HIERS["tpu"], scratch_bytes=2**19),
            "h100": HIERS["h100"]}


HIERARCHIES = _hierarchies()


def _ranked(P, hname, make_cands, cost):
    hier = P.hier(HIERARCHIES[hname])
    cands = make_cands(P.passes, hier)
    model = P.costmodel.CostModel(hier)
    return hier, cands, model.rank(cands, lambda t: cost(model, t))


@pytest.mark.parametrize("hname", sorted(HIERARCHIES))
@pytest.mark.parametrize("m,n,k", [
    (24, 24, 24), (7, 513, 129), (300, 700, 900), (2048, 128, 256)])
def test_ranked_matmul_tilings_respect_scratch(hname, m, n, k):
    def run(P):
        return _ranked(
            P, hname,
            lambda passes, h: passes.candidate_matmul_blocks(m, n, k, 4, h),
            lambda model, t: model.matmul_cost(m, n, k, 4, t))
    hier, cands, ranked = run(PORT)
    assert ranked == run(REF)[2]
    assert cands[0] == PORT.passes.choose_matmul_blocks(m, n, k, 4, hier)
    assert sorted(map(repr, (c for _, c in ranked))) == \
        sorted(map(repr, cands))
    for _, t in ranked:
        fp = (t["bm"] * t["bk"] + t["bk"] * t["bn"]) * 4 \
            + t["bm"] * t["bn"] * 4
        if fp > hier.scratch_bytes // 2:
            assert [t] == cands
        assert t["bm"] % hier.team_width == 0
        assert t["bn"] % hier.vector_width == 0
        assert t["bk"] % hier.vector_width == 0


@pytest.mark.parametrize("hname", sorted(HIERARCHIES))
@pytest.mark.parametrize("shape,n_ops", [
    ((128,), 2), ((256, 512), 3), ((4, 64, 128), 5), ((2, 3, 40, 130), 4)])
def test_ranked_map_tilings_respect_scratch(hname, shape, n_ops):
    def run(P):
        return _ranked(
            P, hname,
            lambda passes, h: passes.candidate_map_blocks(shape, 4, n_ops, h),
            lambda model, t: model.map_cost(shape, 4, n_ops, t))
    hier, cands, ranked = run(PORT)
    assert ranked == run(REF)[2]
    assert cands[0] == PORT.passes.choose_map_blocks(shape, 4, n_ops, hier)
    budget = hier.scratch_bytes // max(2 * n_ops, 2)
    for _, t in ranked:
        if [t] != cands:
            assert int(np.prod(t["block"])) * 4 <= budget
        assert len(t["block"]) == len(shape)
        for s, b, g in zip(shape, t["block"], t["grid"]):
            assert b * g >= s


@pytest.mark.parametrize("hname", sorted(HIERARCHIES))
def test_spmv_candidates_keep_heuristic_first(hname):
    hier = PORT.hier(HIERARCHIES[hname])
    cands = PORT.passes.candidate_spmv_tilings(4096, 12.0, hier)
    assert cands == REF.passes.candidate_spmv_tilings(
        4096, 12.0, REF.hier(HIERARCHIES[hname]))
    assert cands[0] == PORT.passes.choose_spmv_tiling(4096, 12.0, hier)
    assert {t["row_width"] for t in cands} == {cands[0]["row_width"]}


def test_rank_is_stable_on_ties():
    model = cm.CostModel(PORT.backend.H100_HIERARCHY)
    cands = [{"bm": 8, "i": i} for i in range(5)]
    ranked = model.rank(cands, lambda t: 1.0)
    assert [c["i"] for _, c in ranked] == [0, 1, 2, 3, 4]


def test_roofline_shape():
    peaks = cm.default_peaks()
    model = cm.CostModel(PORT.backend.ParallelHierarchy(), peaks)
    mem_bound = model.roofline(bytes_moved=1e9, flops=1.0, launches=1)
    assert mem_bound == pytest.approx(
        1e9 / peaks.bandwidth_bytes_per_s + peaks.launch_overhead_s)
    comp_bound = model.roofline(bytes_moved=1.0, flops=1e12, launches=1)
    assert comp_bound == pytest.approx(
        1e12 / peaks.flops_per_s + peaks.launch_overhead_s)
    assert model.roofline(0.0, 0.0, launches=10) == \
        pytest.approx(10 * peaks.launch_overhead_s)
    ref = REF.costmodel.CostModel(REF.backend.ParallelHierarchy(),
                                  REF.costmodel.default_peaks())
    for args in ((1e9, 1.0, 1), (1.0, 1e12, 1), (0.0, 0.0, 10)):
        assert model.roofline(*args) == ref.roofline(*args)
