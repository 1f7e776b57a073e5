"""The port's static-analysis layer held to the JAX reference on the CPU.

Every case of the reference's ``tests/test_analysis.py`` runs twice:
the same graph is built through ``repro`` (JAX) and through
``repro_torch`` (``device="cpu"``), under the same hierarchy (the same
``ParallelHierarchy`` dict, constructed in each package), and the two
packages' diagnostics must agree field by field — severity, checker,
op, pass, path, message and hint — once SSA ids are renumbered.  The
hand-built graphs run under both the TPU's and the H100's hierarchy.
The fuzz over every pass also compares the IR after every pass.

The H100 cases have no reference counterpart: the port's level names
(``grid`` / ``block`` / ``warp``) and its 232,448-byte scratch budget,
which every tiling the port decides for the mlp demo, qwen2-1.5b's MLP
block at published widths, ResNet18, MALA and the batched products
must fit.

The two-package harness (``REF``, ``PORT``, ``both``, ``rows``) is
shared with the other compiler-core port tests.
"""
import importlib
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.core.tracer import TensorSpec  # noqa: E402
from test_torch_pipeline import \
    _ids_normalized as ids_normalized  # noqa: E402

F32 = "float32"


# ---------------------------------------------------------------------------
# the two-package harness
# ---------------------------------------------------------------------------

class Pkg:
    """One package's compiler modules, with its names for the port's
    targets (``torch`` ↔ ``xla``, ``cuda`` ↔ ``pallas``)."""

    def __init__(self, root, spec, targets, target_kw, **opt_kw):
        self.root = root
        for name in ("analysis", "backend", "costmodel", "emitter", "ir",
                     "ops", "options", "passes", "passmgr", "pipeline",
                     "registry", "tracer", "translate"):
            setattr(self, name, importlib.import_module(
                f"{root}.core.{name}"))
        self.scheduler = importlib.import_module(
            f"{root}.runtime.scheduler")
        self.spec = spec
        self._targets = targets
        self._target_kw = target_kw
        self._opt_kw = opt_kw

    def target(self, port_name: str) -> str:
        return self._targets.get(port_name, port_name)

    def hier(self, d):
        """A ParallelHierarchy of this package from a dict (None stays
        None, a record of this package passes through)."""
        if d is None or not isinstance(d, dict):
            return d
        return self.backend.ParallelHierarchy.from_dict(d)

    def opts(self, target="torch", hierarchy=None, **kw):
        """CompileOptions for the port's target name."""
        t = self.target(target)
        return self.options.CompileOptions(
            target=t, hierarchy=self.hier(hierarchy),
            **{**self._target_kw.get(t, {}), **self._opt_kw, **kw})

    def trace(self, fn, *shapes, dtype=F32):
        return self.tracer.trace(fn, *[self.spec(s, dtype) for s in shapes])


REF = Pkg("repro", jax.ShapeDtypeStruct,
          {"torch": "xla", "cuda": "pallas"}, {"pallas": {"interpret": True}})
PORT = Pkg("repro_torch", TensorSpec, {}, {}, device="cpu")
PKGS = (REF, PORT)

# the two declared device hierarchies, as data each package can rebuild
HIERS = {"tpu": REF.backend.TPU_HIERARCHY.to_dict(),
         "h100": PORT.backend.H100_HIERARCHY.to_dict()}
H100_BUDGET = PORT.backend.H100_HIERARCHY.scratch_bytes


def rows(diags) -> list:
    """Every field of every diagnostic, SSA ids renumbered over the
    whole list (the same value keeps one name across diagnostics)."""
    flat = "\x1f".join("\x1e".join((d.severity, d.checker, d.op,
                                    d.pass_name, d.path, d.message, d.hint))
                       for d in diags)
    return [tuple(r.split("\x1e"))
            for r in ids_normalized(flat).split("\x1f") if r]


def both(case):
    """``case(pkg)`` → diagnostics, in each package; they must agree
    field by field.  → the port's."""
    ref, port = case(REF), case(PORT)
    assert rows(port) == rows(ref)
    return port


def diagnostics_of(graph) -> tuple:
    return tuple(getattr(graph, "diagnostics", ()))


def errors_of(graph) -> list:
    return [d for d in diagnostics_of(graph) if d.severity == "error"]


# ---------------------------------------------------------------------------
# running a graph under verify="full"
# ---------------------------------------------------------------------------

def _noop(graph, options=None):
    return 0


def reject(P, graph, options=None, checker=None):
    """A no-op pipeline under verify="full": it must raise, every
    diagnostic op- and pass-attributed.  → the diagnostics."""
    pm = P.passmgr.PassManager((_noop,), verify="full")
    with pytest.raises(P.passmgr.IRVerificationError) as ei:
        pm.run(graph, options or P.opts("torch"))
    diags = ei.value.diagnostics
    assert diags, "error raised without structured diagnostics"
    for d in diags:
        assert d.pass_name == "_noop"
        assert d.op and d.path and d.message
    if checker is not None:
        assert any(d.checker == checker for d in diags), \
            [d.format() for d in diags]
    return diags


def accept(P, graph, options=None):
    """A no-op pipeline under verify="full" that must not raise.  → the
    diagnostics it recorded (warnings)."""
    out = P.passmgr.PassManager((_noop,), verify="full").run(
        graph, options or P.opts("torch"))
    return diagnostics_of(out)


# ---------------------------------------------------------------------------
# dialect verifier
# ---------------------------------------------------------------------------

def _region_orphan(P):
    ir = P.ir
    t = ir.TensorType((4,), F32)
    x, orphan, arg = ir.Value(t), ir.Value(t), ir.Value(t)
    g = ir.Graph("bad_region", [x])
    sub = ir.Op("linalg.relu", [orphan], [t])
    fused = ir.Op("kokkos.fused", [x], [t], attrs={"ops": ("linalg.relu",)},
                  regions=[ir.Region([arg], [sub], [sub.results[0]])])
    g.add(fused)
    g.outputs = [fused.results[0]]
    with pytest.raises(P.passmgr.IRVerificationError) as ei:
        P.passmgr.verify_graph(g)
    return ei.value.diagnostics


def test_verify_graph_catches_region_orphan_operand():
    diags = both(_region_orphan)
    assert any("neither a block arg" in d.message for d in diags)


def test_verify_graph_still_catches_toplevel_ssa_violation():
    def case(P):
        ir = P.ir
        t = ir.TensorType((2,), F32)
        x, orphan = ir.Value(t), ir.Value(t)
        g = ir.Graph("bad", [x])
        bad = ir.Op("linalg.relu", [orphan], [t])
        g.add(bad)
        g.outputs = [bad.results[0]]
        with pytest.raises(P.passmgr.IRVerificationError) as ei:
            P.passmgr.verify_graph(g)
        return ei.value.diagnostics
    assert both(case)


def _fused_graph(P, name, arg_types, sub_type):
    ir = P.ir
    t = ir.TensorType((4,), F32)
    x = ir.Value(t)
    g = ir.Graph(name, [x])
    args = [ir.Value(ir.TensorType(s, F32)) for s in arg_types]
    sub = ir.Op("linalg.relu", [args[0]], [ir.TensorType(sub_type, F32)])
    fused = ir.Op("kokkos.fused", [x], [t],
                  regions=[ir.Region(args, [sub], [sub.results[0]])])
    g.add(fused)
    g.outputs = [fused.results[0]]
    return g


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_block_arg_arity_mismatch_rejected(hier):
    diags = both(lambda P: reject(P, _fused_graph(
        P, "arity", [(4,), (4,)], (4,)), P.opts(hierarchy=HIERS[hier]),
        checker="dialect"))
    assert any("block args" in d.message for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_block_arg_shape_mismatch_rejected(hier):
    diags = both(lambda P: reject(P, _fused_graph(
        P, "mirror", [(8,)], (8,)), P.opts(hierarchy=HIERS[hier]),
        checker="dialect"))
    assert any("block arg 0" in d.message for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_bad_page_copy_direction_rejected(hier):
    def case(P):
        ir = P.ir
        t = ir.TensorType((4, 2, 4, 8), F32)
        ti = ir.TensorType((2,), "int32")
        pool, ids1, ids2 = ir.Value(t), ir.Value(ti), ir.Value(ti)
        g = ir.Graph("dir", [pool, ids1, ids2])
        op = ir.Op("kokkos.page_copy", [pool, pool, ids1, ids2], [t],
                   attrs={"direction": "sideways", "block_size": 4})
        g.add(op)
        g.outputs = [op.results[0]]
        return reject(P, g, P.opts(hierarchy=HIERS[hier]),
                      checker="dialect")
    assert any("direction" in d.message for d in both(case))


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_arity_violation_rejected(hier):
    def case(P):
        ir = P.ir
        t = ir.TensorType((4,), F32)
        x = ir.Value(t)
        g = ir.Graph("arity2", [x])
        g.add(ir.Op("kokkos.sync", [x, x], [], attrs={"space": "device"}))
        g.outputs = [x]
        return reject(P, g, P.opts(hierarchy=HIERS[hier]),
                      checker="dialect")
    assert any("operands" in d.message for d in both(case))


def _level_graph(P, level_map, nest=None, shape=(128,)):
    ir = P.ir
    t = ir.TensorType(shape, F32)
    x = ir.Value(t)
    g = ir.Graph("levels", [x])
    nest = nest or (ir.LoopLevel("range", shape[0]),)
    op = ir.Op("kokkos.range_parallel" if len(nest) == 1
               else "kokkos.team_parallel", [x], [t],
               attrs={"nest": nest, "kind": "map", "iter_space": shape,
                      "level_map": level_map})
    g.add(op)
    g.outputs = [op.results[0]]
    return g


# the name each hierarchy must refuse: the other device's innermost level
_FOREIGN_LEVEL = {"tpu": "warp", "h100": "lane"}


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_level_map_name_outside_declared_hierarchy_rejected(hier):
    name = _FOREIGN_LEVEL[hier]
    diags = both(lambda P: reject(
        P, _level_graph(P, (name,)),
        P.opts("cuda", hierarchy=HIERS[hier]), checker="dialect"))
    assert any(name in d.message and "hierarchy" in d.message
               for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_level_map_length_must_match_nest(hier):
    def case(P):
        nest = (P.ir.LoopLevel("team", 8), P.ir.LoopLevel("vector", 128))
        inner = P.backend.ParallelHierarchy.from_dict(
            HIERS[hier]).levels[-1].name
        return reject(P, _level_graph(P, (inner,), nest, (8, 128)),
                      P.opts("cuda", hierarchy=HIERS[hier]),
                      checker="dialect")
    assert any("level_map has 1" in d.message for d in both(case))


def test_h100_level_names_are_the_only_ones_accepted():
    """The port's ``cuda`` backend declares grid → block → warp: each of
    those verifies on a one-level nest, and the TPU's and other GPU
    spellings are refused, as the reference refuses them under the same
    hierarchy."""
    for name in ("grid", "block", "warp"):
        assert not both(lambda P: accept(
            P, _level_graph(P, (name,)),
            P.opts("cuda", hierarchy=HIERS["h100"])))
        assert not accept(PORT, _level_graph(PORT, (name,)),
                          PORT.opts("cuda"))
    for name in ("lane", "sublane", "thread", "threadIdx"):
        diags = both(lambda P: reject(
            P, _level_graph(P, (name,)),
            P.opts("cuda", hierarchy=HIERS["h100"]), checker="dialect"))
        assert any(name in d.message for d in diags)
        reject(PORT, _level_graph(PORT, (name,)), PORT.opts("cuda"),
               checker="dialect")


# ---------------------------------------------------------------------------
# checker 1: parallel races
# ---------------------------------------------------------------------------

def _map_nest(P, in_shape, out_shape, trips, names=None, kind="map",
              sub=None):
    """A nest over ``trips`` reading a ``in_shape`` input; ``sub`` →
    (opname, attrs) of a one-op region body."""
    ir = P.ir
    t_in, t_out = ir.TensorType(in_shape, F32), ir.TensorType(out_shape, F32)
    x = ir.Value(t_in)
    g = ir.Graph("race", [x])
    names = names or (("range",) if len(trips) == 1 else ("team", "vector"))
    nest = tuple(ir.LoopLevel(n, tr) for n, tr in zip(names, trips))
    region = None
    if sub is not None:
        arg = ir.Value(t_in)
        s = ir.Op(sub[0], [arg], [t_in], attrs=sub[1])
        region = ir.Region([arg], [s], [s.results[0]])
    op = ir.Op("kokkos.range_parallel" if len(nest) == 1
               else "kokkos.team_parallel", [x], [t_out],
               attrs={"nest": nest, "kind": kind,
                      "iter_space": tuple(in_shape)},
               regions=[region] if region else None)
    g.add(op)
    g.outputs = [op.results[0]]
    return g


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_race_map_nest_wider_than_output_rejected(hier):
    diags = both(lambda P: reject(
        P, _map_nest(P, (4,), (4,), (64,)), P.opts(hierarchy=HIERS[hier]),
        checker="race"))
    assert any("write-write" in d.message for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_race_reduce_nest_wider_than_output_is_clean(hier):
    # reductions legitimately have more iterations than output elements
    assert not both(lambda P: accept(
        P, _map_nest(P, (64,), (1,), (64,), kind="reduce"),
        P.opts(hierarchy=HIERS[hier])))


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_race_reduction_subop_inside_map_body_rejected(hier):
    diags = both(lambda P: reject(
        P, _map_nest(P, (8,), (8,), (8,), sub=("linalg.reduce_sum", {})),
        P.opts(hierarchy=HIERS[hier]), checker="race"))
    assert any("reduction sub-op" in d.message for d in diags)
    race = [d for d in diags if d.checker == "race"][0]
    assert race.op == "linalg.reduce_sum"
    assert "kokkos.range_parallel" in race.path


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_race_seeded_non_injective_index_map_rejected(hier):
    diags = both(lambda P: reject(
        P, _map_nest(P, (8, 8), (8, 8), (8, 8),
                     sub=("linalg.relu", {"index_map": (0, 0)})),
        P.opts(hierarchy=HIERS[hier]), checker="race"))
    assert any("index_map" in d.message for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_race_injective_index_map_is_clean(hier):
    assert not both(lambda P: accept(
        P, _map_nest(P, (8, 8), (8, 8), (8, 8),
                     sub=("linalg.relu", {"index_map": (0, 1)})),
        P.opts(hierarchy=HIERS[hier])))


# ---------------------------------------------------------------------------
# checker 2: DualView sync state
# ---------------------------------------------------------------------------

def _dual_graph(P, syncs=0, modify=False):
    ir = P.ir
    t_dual = ir.TensorType((4,), F32, ir.MemorySpace.DUAL)
    t = ir.TensorType((4,), F32)
    g = ir.Graph("dual", [])
    const = ir.Op("tensor.constant", [], [t_dual],
                  attrs={"value": np.zeros(4, np.float32)})
    g.add(const)
    v = const.results[0]
    for _ in range(syncs):
        g.add(ir.Op("kokkos.sync", [v], [],
                    attrs={"space": "device", "lazy": True}))
    if modify:
        g.add(ir.Op("kokkos.modify", [v], [], attrs={"space": "host"}))
    use = ir.Op("linalg.relu", [v], [t], attrs={"exec_space": "device"})
    g.add(use)
    g.outputs = [use.results[0]]
    return g


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_sync_device_read_of_host_dual_without_sync_rejected(hier):
    diags = both(lambda P: reject(P, _dual_graph(P),
                                  P.opts(hierarchy=HIERS[hier]),
                                  checker="sync"))
    sync = [d for d in diags if d.checker == "sync"][0]
    assert "device read" in sync.message
    assert "kokkos.sync" in sync.hint
    assert sync.op == "linalg.relu"


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_sync_after_kokkos_sync_is_clean(hier):
    assert not both(lambda P: accept(P, _dual_graph(P, syncs=1),
                                     P.opts(hierarchy=HIERS[hier])))


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_sync_redundant_double_sync_warns_but_passes(hier):
    diags = both(lambda P: accept(P, _dual_graph(P, syncs=2),
                                  P.opts(hierarchy=HIERS[hier])))
    assert diags and all(d.severity == "warning" for d in diags)
    assert any("redundant" in d.message for d in diags)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_sync_modify_dirties_and_requires_resync(hier):
    both(lambda P: reject(P, _dual_graph(P, syncs=1, modify=True),
                          P.opts(hierarchy=HIERS[hier]), checker="sync"))


# ---------------------------------------------------------------------------
# checker 3: scratch budget
# ---------------------------------------------------------------------------

TINY = {"exec_space": "device",
        "levels": [{"name": "grid"}, {"name": "block", "width": 8},
                   {"name": "lane", "width": 128}],
        "scratch_bytes": 1024, "compute_unit": 128}


def _tiled_nest(P, block, n_extra_subops=0, n=4096, dtype=F32):
    ir = P.ir
    t = ir.TensorType((n,), dtype)
    x = ir.Value(t)
    g = ir.Graph("scratch", [x])
    region = None
    if n_extra_subops:
        arg = ir.Value(t)
        subs, prev = [], arg
        for _ in range(n_extra_subops):
            s = ir.Op("linalg.relu", [prev], [t])
            subs.append(s)
            prev = s.results[0]
        region = ir.Region([arg], subs, [prev])
    op = ir.Op("kokkos.range_parallel", [x], [t],
               attrs={"nest": (ir.LoopLevel("range", n),), "kind": "map",
                      "iter_space": (n,),
                      "tiling": {"block": block, "grid": (1,)}},
               regions=[region] if region else None)
    g.add(op)
    g.outputs = [op.results[0]]
    return g


def test_tiny_hierarchy_is_the_references():
    assert PORT.hier(TINY) == PORT.backend.ParallelHierarchy(
        exec_space="device",
        levels=(PORT.backend.LevelSpec("grid"),
                PORT.backend.LevelSpec("block", width=8),
                PORT.backend.LevelSpec("lane", width=128)),
        scratch_bytes=1024, compute_unit=128)
    assert REF.hier(TINY).to_dict() == PORT.hier(TINY).to_dict()


def test_scratch_over_budget_nest_rejected():
    # 4096 f32 x (1 operand + 1 output) = 32 KiB >> 1 KiB budget
    diags = both(lambda P: reject(P, _tiled_nest(P, (4096,)),
                                  P.opts("cuda", hierarchy=TINY),
                                  checker="scratch"))
    d = [x for x in diags if x.checker == "scratch"][0]
    assert "scratch_bytes=1024" in d.message
    assert "shrink the tiling" in d.hint


def test_scratch_fused_intermediates_count():
    assert not both(lambda P: accept(P, _tiled_nest(P, (64,)),
                                     P.opts("cuda", hierarchy=TINY)))
    both(lambda P: reject(P, _tiled_nest(P, (64,), n_extra_subops=8),
                          P.opts("cuda", hierarchy=TINY),
                          checker="scratch"))


def test_scratch_gemm_panels_rejected_over_tiny_budget():
    def case(P):
        ir = P.ir
        t = ir.TensorType((64, 64), F32)
        a, b = ir.Value(t), ir.Value(t)
        g = ir.Graph("gemm_scratch", [a, b])
        op = ir.Op("kk.gemm", [a, b], [t],
                   attrs={"tiling": {"bm": 64, "bn": 64, "bk": 64}})
        g.add(op)
        g.outputs = [op.results[0]]
        return reject(P, g, P.opts("cuda", hierarchy=TINY),
                      checker="scratch")
    both(case)


def test_scratch_default_hierarchy_accepts_decided_tilings():
    """What the passes decide against each package's own device budget
    verifies clean, and under the H100's budget the reference decides
    and reports what the port does."""
    def run(P, **kw):
        g = P.trace(lambda x: P.ops.relu(x), (64, 256))
        with P.options.use_options(P.opts("cuda", verify_ir="full",
                                          **kw)) as o:
            out = P.passes.run_pipeline(g, o)
        return out
    for P in PKGS:
        assert not errors_of(run(P))
    ref, port = (run(P, hierarchy=HIERS["h100"]) for P in PKGS)
    assert rows(diagnostics_of(port)) == rows(diagnostics_of(ref))
    assert ids_normalized(str(port)) == ids_normalized(str(ref))


# the H100's own budget: 232,448 bytes a block (sm_90's 227 KiB opt-in)

def test_h100_budget_is_the_sm90_opt_in_maximum():
    assert H100_BUDGET == 227 * 1024 == 232_448
    assert PORT.backend.get_backend("cuda").hierarchy.scratch_bytes \
        == H100_BUDGET


@pytest.mark.parametrize("over", [0, 1], ids=["at-budget", "one-byte-over"])
def test_h100_nest_one_byte_over_budget_rejected(over):
    """int8 nests: one operand and two fused sub-ops hold three bytes an
    element, so a block of 77,483 elements needs 232,449 bytes, one byte
    over the budget; one operand and its output (two bytes an element)
    at 116,224 elements fit it exactly.  The port rejects the first with
    the reference's diagnostic under the same hierarchy."""
    def graph(P):
        if over:
            return _tiled_nest(P, (77_483,), n_extra_subops=2, n=77_483,
                               dtype="int8")
        return _tiled_nest(P, (116_224,), n=116_224, dtype="int8")
    if not over:
        assert not both(lambda P: accept(
            P, graph(P), P.opts("cuda", hierarchy=HIERS["h100"])))
        assert not accept(PORT, graph(PORT), PORT.opts("cuda"))
        return
    diags = both(lambda P: reject(P, graph(P),
                                  P.opts("cuda", hierarchy=HIERS["h100"]),
                                  checker="scratch"))
    (d,) = [x for x in diags if x.checker == "scratch"]
    assert "scratch footprint 232449B exceeds the declared " \
        "scratch_bytes=232448B" in d.message
    assert d.hint == ("shrink the tiling or declare a larger scratch tier "
                      "on the backend's ParallelHierarchy")
    own = reject(PORT, graph(PORT), PORT.opts("cuda"), checker="scratch")
    assert rows(own) == rows(diags)


def _footprints(graph) -> list:
    """Each decided tiling's scratch bytes, counted here as the checker
    counts them (nests, gemm panels, staged pages, sparse row blocks)."""
    from repro_torch.core.ir import KOKKOS_PARALLEL_OPS, dtype_itemsize
    out = []
    for op in graph.ops:
        t = op.attrs.get("tiling")
        if not isinstance(t, dict):
            continue
        if "block" in t and op.opname in KOKKOS_PARALLEL_OPS:
            n_scr = len(op.regions[0].ops) if op.regions else 0
            out.append(int(np.prod(t["block"])) * dtype_itemsize(
                op.results[0].type.dtype) * (len(op.operands) + (n_scr or 1)))
        elif {"bm", "bn", "bk"} <= t.keys():
            out.append((t["bm"] * t["bk"] + t["bk"] * t["bn"])
                       * dtype_itemsize(op.operands[0].type.dtype)
                       + t["bm"] * t["bn"] * 4)
        elif "blocks_per_team" in t:
            out.append(2 * t["blocks_per_team"] * t["block_bytes"])
        elif "row_block" in t and "row_width" in t:
            out.append(t["row_block"] * t["row_width"] * 64)
    return out


@pytest.fixture(scope="module")
def _one_torch_thread():
    """One torch intra-op thread while the full-width compiles run: the
    suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h100_workload(name):
    """(fn, specs) of a workload the port compiles for the card."""
    from repro_torch.core import ops
    if name == "mlp_demo":
        fn, specs, _ = PORT.pipeline._demo_mlp()
        return fn, specs
    if name.startswith("qwen2_block"):
        from repro_torch.configs import get_config
        from repro_torch.models.mlp import gated_mlp_block
        cfg = get_config("qwen2-1.5b")
        dt = "bfloat16" if name.endswith("bf16") else F32
        g = torch.Generator().manual_seed(0)
        p = {k: torch.empty(s, dtype=getattr(torch, dt)).normal_(
            generator=g) for k, s in (("w_gate", (cfg.d_model, cfg.d_ff)),
                                      ("w_up", (cfg.d_model, cfg.d_ff)),
                                      ("w_down", (cfg.d_ff, cfg.d_model)))}
        return (lambda x: gated_mlp_block(p, x, act=cfg.act),
                (TensorSpec((2048, cfg.d_model), dt),))
    from repro_torch.models import resnet
    if name == "resnet18":
        w = resnet.init_resnet18_weights(np.random.default_rng(0),
                                         width_mult=0.25, device="cpu")
        return (lambda x: resnet.resnet18_forward(w, x, width_mult=0.25),
                (TensorSpec((2, 3, 32, 32), F32),))
    if name == "mala":
        w = resnet.init_mala_weights(np.random.default_rng(1), device="cpu")
        return (lambda x: resnet.mala_forward(w, x),
                (TensorSpec((8748, 91), F32),))
    sa, sb, dt = BATCHED[name]
    return (lambda a, b: ops.matmul(a, b),
            (TensorSpec(sa, dt), TensorSpec(sb, dt)))


# the batched products the card runs (paper Fig 6.3's four, 16384 small
# matrices, one sequence's per-head QKᵀ, a broadcast up-projection)
BATCHED = {f"bmm_{'x'.join(map(str, sa))}_{dt}": (sa, sb, dt)
           for sa, sb in (((256, 16, 16), (256, 16, 16)),
                          ((256, 32, 32), (256, 32, 32)),
                          ((64, 64, 64), (64, 64, 64)),
                          ((16, 128, 128), (16, 128, 128)),
                          ((16384, 32, 32), (16384, 32, 32)),
                          ((12, 2048, 128), (12, 128, 2048)),
                          ((8, 256, 1536), (1536, 8960)))
           for dt in (F32, "bfloat16")}
H100_WORKLOADS = ["mlp_demo", "qwen2_block_f32", "qwen2_block_bf16",
                  "resnet18", "mala", *BATCHED]


@pytest.mark.parametrize("name", H100_WORKLOADS)
def test_h100_decided_tilings_fit_the_scratch_budget(name,
                                                     _one_torch_thread):
    """Every tiling the port decides for the card fits its 232,448 bytes:
    the compile under verify="full" reports no error, and the footprints,
    counted again here, are all within the budget."""
    fn, specs = _h100_workload(name)
    mod = PORT.pipeline.compile(fn, *specs, options=PORT.opts(
        "cuda", verify_ir="full"))
    assert not errors_of(mod.graph), [d.format()
                                      for d in errors_of(mod.graph)]
    fps = _footprints(mod.graph)
    assert fps, "no decided tiling to check"
    assert max(fps) <= H100_BUDGET, (name, max(fps))


def test_kernels_shared_memory_limit_is_the_checkers_budget():
    """The kernels' launchers opt in to the shared memory the H100
    hierarchy declares: one number, so the checker's budget is what the
    launches may take."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import matmul
    assert matmul.MAX_SMEM_BYTES == flash_attention.SMEM_LIMIT == \
        decode_attention.SMEM_LIMIT == H100_BUDGET


@pytest.mark.parametrize("name", H100_WORKLOADS)
def test_h100_launch_plans_fit_the_scratch_budget(name, _one_torch_thread):
    """Each product the card launches for a workload, planned as its
    launcher plans it (``gemm_plan``, the batched plans): the dynamic
    shared memory is within the budget (``chip_smoke.py`` phase 20b
    prints the same plans on the card)."""
    from repro_torch.core.tracer import torch_dtype
    from repro_torch.kernels import batched_gemm as bgm
    from repro_torch.kernels import matmul as mm
    fn, specs = _h100_workload(name)
    mod = PORT.pipeline.compile(fn, *specs, options=PORT.opts("cuda"))
    plans = []
    for op in mod.graph.ops:
        if op.opname not in ("kk.gemm", "kk.batched_gemm"):
            continue
        a_t, b_t = (o.type for o in op.operands)
        dt = torch_dtype(a_t.dtype)
        if op.opname == "kk.gemm":
            (m, k), n = a_t.shape, b_t.shape[1]
            plans.append(mm.gemm_plan(m, n, k, 1, dt, True))
        elif op.opname == "kk.batched_gemm":
            *batch, m, k = a_t.shape
            n = b_t.shape[-1]
            small, _, _, bk, bb = bgm.check_tiling(op.attrs["tiling"], m, n)
            plans.append(bgm.small_plan(m, n, k, int(np.prod(batch)), bb,
                                        dt.itemsize, bk) if small else
                         bgm.plan_for(torch.empty(a_t.shape, dtype=dt),
                                      torch.empty(b_t.shape, dtype=dt)))
    assert plans
    assert max(p["smem_bytes"] for p in plans) <= H100_BUDGET


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_plans_fit_the_scratch_budget(d):
    from repro_torch.kernels import flash_attention as fa
    assert fa.sm90_plan(d)["smem_bytes"] <= H100_BUDGET
    assert fa.ffma_plan(d)["smem_bytes"] <= H100_BUDGET


# ---------------------------------------------------------------------------
# checker 4: paged alias (the allocator's CoW contract)
# ---------------------------------------------------------------------------

def _paged_values(P, n_blocks=8, heads=2, bs=4, hd=8, slots=2, mb=3):
    ir = P.ir
    types = (ir.TensorType((n_blocks, heads, bs, hd), F32),
             ir.TensorType((slots, mb), "int32"),
             ir.TensorType((slots,), "int32"),
             ir.TensorType((slots, heads, hd), F32))
    return [ir.Value(t) for t in types], ir.TensorType((2,), "int32")


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_paged_shared_block_write_without_fork_rejected(hier):
    def case(P):
        ir = P.ir
        vals, _ = _paged_values(P)
        g = ir.Graph("cow", vals)
        op = ir.Op("paged.append", vals, [vals[0].type],
                   attrs={"block_size": 4, "shared_block_ids": (3, 5)})
        g.add(op)
        g.outputs = [op.results[0]]
        return reject(P, g, P.opts(hierarchy=HIERS[hier]),
                      checker="paged-alias")
    d = [x for x in both(case) if x.checker == "paged-alias"][0]
    assert "[3, 5]" in d.message
    assert "fork" in d.hint


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_paged_fork_before_shared_write_is_clean(hier):
    def case(P):
        ir = P.ir
        (pool, tab, ln, kv), t_ids = _paged_values(P)
        ids_s, ids_d = ir.Value(t_ids), ir.Value(t_ids)
        g = ir.Graph("cow_ok", [pool, tab, ln, kv, ids_s, ids_d])
        fork = ir.Op("paged.copy", [pool, pool, ids_s, ids_d], [pool.type],
                     attrs={"block_size": 4, "fork_block_ids": (3, 5)})
        g.add(fork)
        app = ir.Op("paged.append", [fork.results[0], tab, ln, kv],
                    [pool.type],
                    attrs={"block_size": 4, "shared_block_ids": (3, 5)})
        g.add(app)
        g.outputs = [app.results[0]]
        return accept(P, g, P.opts(hierarchy=HIERS[hier]))
    assert not both(case)


@pytest.mark.parametrize("hier", sorted(HIERS))
def test_paged_alias_end_to_end_through_real_pipeline(hier):
    bs, heads, hd, nb, slots, mb = 4, 2, 8, 8, 2, 3
    shapes = (((nb, heads, bs, hd), F32), ((slots, mb), "int32"),
              ((slots,), "int32"), ((slots, heads, hd), F32),
              ((1,), "int32"), ((1,), "int32"))

    def fns(ops):
        def bad(pool, tab, ln, kv, src, dst):
            return ops.page_append(pool, tab, ln, kv, block_size=bs,
                                   shared_block_ids=(2,))

        def good(pool, tab, ln, kv, src, dst):
            pool = ops.page_copy(pool, pool, src, dst, block_size=bs,
                                 fork_block_ids=(2,))
            return ops.page_append(pool, tab, ln, kv, block_size=bs,
                                   shared_block_ids=(2,))
        return bad, good

    def bad_case(P):
        with pytest.raises(P.passmgr.IRVerificationError) as ei:
            P.pipeline.compile(fns(P.ops)[0], *[P.spec(s, d)
                                                for s, d in shapes],
                               options=P.opts(hierarchy=HIERS[hier],
                                              verify_ir="full"))
        return ei.value.diagnostics
    assert any(d.checker == "paged-alias" for d in both(bad_case))

    mods = [P.pipeline.compile(fns(P.ops)[1], *[P.spec(s, d)
                                                for s, d in shapes],
                               options=P.opts(hierarchy=HIERS[hier],
                                              verify_ir="full"))
            for P in PKGS]
    assert rows(diagnostics_of(mods[1].graph)) == \
        rows(diagnostics_of(mods[0].graph))
    assert not errors_of(mods[1].graph)
    dump = mods[1].print_ir()
    assert "shared_block_ids" in dump and "fork_block_ids" in dump
    assert ids_normalized(dump) == ids_normalized(mods[0].print_ir())


def test_allocator_exports_rc_invariant():
    def case(P):
        sched = P.scheduler
        alloc = sched.BlockAllocator(8)
        ids = alloc.alloc(3)
        seen = [alloc.shared_blocks()]
        alloc.share([ids[1]])
        seen.append(alloc.shared_blocks())
        s = sched.ContinuousScheduler(2, alloc, block_size=4,
                                      max_blocks_per_slot=4)
        seen.append(s.alias_invariant())
        alloc.release([ids[1]])
        seen.append(alloc.shared_blocks())
        return ids, seen
    (ref_ids, ref), (ids, got) = case(REF), case(PORT)
    assert (ids, got) == (ref_ids, ref)
    assert got == [(), (ids[1],), {"shared_blocks": (ids[1],)}, ()]


# ---------------------------------------------------------------------------
# framework: def-use and alias sets
# ---------------------------------------------------------------------------

def test_def_use_descends_into_regions():
    def case(P):
        g = P.trace(lambda x: P.ops.relu(P.ops.add(x, x)), (8, 16))
        with P.options.use_options(P.opts("cuda")):
            P.passes.fuse_elementwise(g)
        du = P.analysis.def_use(g)
        fused = [op for op in g.ops if op.opname == "kokkos.fused"]
        assert fused, "fusion did not fire"
        region = fused[0].regions[0]
        for arg in region.inputs:
            assert du.defs[arg.id][0] == "block-arg"
            assert any(u[0] in region.ops for u in du.uses.get(arg.id, []))
        for sub in region.ops:
            for r in sub.results:
                assert du.defs[r.id][0] == "sub-op"
        # the whole table, ids renumbered: kinds of defs, uses' paths
        return ids_normalized(repr(sorted(
            (f"%{vid}", kind, sorted(ids_normalized(p) for _, _, p in
                                     du.uses.get(vid, [])))
            for vid, (kind, _) in du.defs.items())))
    assert case(PORT) == case(REF)


def test_alias_sets_see_through_paged_and_pack():
    def case(P):
        ir = P.ir
        vals, _ = _paged_values(P)
        g = ir.Graph("alias", vals)
        app = ir.Op("paged.append", vals, [vals[0].type],
                    attrs={"block_size": 4})
        g.add(app)
        g.outputs = [app.results[0]]
        als = P.analysis.buffer_alias_sets(g)
        return [als.same(app.results[0].id, v.id) for v in vals]
    got = case(PORT)
    assert got == case(REF)
    assert got[0] and not got[3]     # the pool aliases; kv is read-only


def test_alias_sets_see_through_sparse_pack():
    """``sparse.pack`` assembles one composite value from its three
    arrays: each aliases it in both packages."""
    def case(P):
        fn, specs, _ = P.pipeline._DEMOS["spmv"]()
        g = P.tracer.trace(fn, *specs)
        als = P.analysis.buffer_alias_sets(g)
        (pack,) = [op for op in g.ops if op.opname == "sparse.pack"]
        return [als.same(pack.results[0].id, v.id) for v in pack.operands]
    assert case(PORT) == case(REF)


# ---------------------------------------------------------------------------
# every registered pass maps verifier-clean graphs to verifier-clean
# graphs on every backend (randomized IR fuzz), IR for IR
# ---------------------------------------------------------------------------

# frozen at collection time: a backend test registers a throwaway plugin
# backend at runtime that must not leak in
PORT_BACKENDS = [b.name for b in PORT.backend.all_backends()]


def random_fn(P, seed: int):
    rng = random.Random(seed)
    n_ops = rng.randint(2, 5)
    w = np.asarray(np.random.default_rng(seed).standard_normal((16, 16)),
                   dtype=np.float32)
    ops = P.ops

    def fn(x):
        h = x
        for _ in range(n_ops):
            kind = rng.choice(["relu", "add", "mul", "exp", "matmul",
                               "softmax"])
            if kind == "relu":
                h = ops.relu(h)
            elif kind == "add":
                h = ops.add(h, h)
            elif kind == "mul":
                h = ops.mul(h, h)
            elif kind == "exp":
                h = ops.exp(h)
            elif kind == "matmul":
                h = ops.matmul(h, ops.constant(w))
            else:
                h = ops.softmax(h)
        return h
    return fn


def _fuzz_run(P, seed, backend):
    """The backend's pipeline under verify="full", the IR printed after
    every pass.  The reference runs its counterpart under the port
    backend's declared hierarchy."""
    port_b = PORT.backend.get_backend(backend)
    g = P.trace(random_fn(P, seed), (8, 16))
    dumped = []
    pm = P.passmgr.PassManager(
        P.backend.get_backend(P.target(backend)).pipeline, verify="full",
        print_ir_after_all=True, sink=dumped.append)
    out = pm.run(g, P.opts(backend, hierarchy=port_b.hierarchy.to_dict()))
    return diagnostics_of(out), ids_normalized("\n".join(dumped))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_every_pass_preserves_verifier_cleanliness(seed):
    for backend in PORT_BACKENDS:
        diags, dump = _fuzz_run(PORT, seed, backend)
        assert not [d for d in diags if d.severity == "error"], backend
        ref_diags, ref_dump = _fuzz_run(REF, seed, backend)
        assert rows(diags) == rows(ref_diags), backend
        assert dump.count("IR after") == len(
            PORT.backend.get_backend(backend).pipeline)
        assert dump == ref_dump, backend


# ---------------------------------------------------------------------------
# demo + golden modules analyze clean; diagnostics ride into emitted text
# ---------------------------------------------------------------------------

DEMOS = sorted(PORT.pipeline._DEMOS)


def _verified(P, fn, specs, target, hierarchy=None, name=None):
    return P.pipeline.compile(fn, *specs, options=P.opts(
        target, verify_ir="full", hierarchy=hierarchy), name=name)


@pytest.mark.parametrize("demo", DEMOS)
@pytest.mark.parametrize("target", ["torch", "loops", "cuda", "auto"])
def test_demo_graphs_analyze_clean(demo, target):
    """Each demo compiles clean on each port target; the reference's
    counterpart under the port backend's hierarchy reports the same.
    (``cuda`` reads CSR where ``pallas`` converts to ELL, so its spmv
    graph holds no ``sparse.convert``; the diagnostics still agree.)"""
    hier = PORT.backend.get_backend(target).hierarchy.to_dict()
    mods = [_verified(P, *P.pipeline._DEMOS[demo]()[:2], target,
                      hierarchy=hier) for P in PKGS]
    assert not errors_of(mods[1].graph)
    assert rows(diagnostics_of(mods[1].graph)) == \
        rows(diagnostics_of(mods[0].graph))
    own = _verified(PORT, *PORT.pipeline._DEMOS[demo]()[:2], target)
    assert not errors_of(own.graph)


def test_golden_translate_modules_analyze_clean():
    import test_torch_translate as tt
    for name, build in tt.GRAPHS.items():
        for backend in tt.BACKENDS:
            hier = PORT.backend.get_backend(backend).hierarchy.to_dict()
            mods = [_verified(P, *build(P.ops, P.spec), backend,
                              hierarchy=hier, name=name) for P in PKGS]
            errs = errors_of(mods[1].graph)
            assert not errs, (name, backend, [d.format() for d in errs])
            assert rows(diagnostics_of(mods[1].graph)) == \
                rows(diagnostics_of(mods[0].graph)), (name, backend)


@pytest.mark.parametrize("demo", DEMOS)
@pytest.mark.parametrize("target", ["torch", "loops", "cuda", "auto"])
def test_analyze_cli_reports_clean(demo, target, capsys):
    jt = REF.target(target)
    assert REF.pipeline.main(["--demo", demo, "--target", jt,
                              "--analyze"]) == 0
    ref = capsys.readouterr().out
    assert PORT.pipeline.main(["--demo", demo, "--target", target,
                               "--device", "cpu", "--analyze"]) == 0
    out = capsys.readouterr().out
    assert f"analysis: {demo}" in out
    assert "errors: 0" in out and "clean" in out
    assert out.replace(f"target={target}", f"target={jt}") == ref


def test_diagnostics_ride_into_emitted_source():
    def case(P):
        fn, specs, _ = P.pipeline._DEMOS["mlp"]()
        opts = P.opts("loops")
        mod = P.pipeline.compile(fn, *specs, options=opts)
        P.analysis.record_diagnostics(mod.graph, [P.analysis.Diagnostic(
            "warning", "sync", "kokkos.sync", "mlp/kokkos.sync",
            "redundant sync", "drop it", "memory_space_management")])
        py = P.emitter.emit_python_source(mod.graph, opts)
        cpp = P.translate.emit_cpp_source(mod.graph, opts)
        return ([ln.strip() for ln in py.splitlines() if "analysis:" in ln],
                [ln.strip() for ln in cpp.splitlines() if "analysis:" in ln])
    py, cpp = case(PORT)
    assert any("# analysis: warning[sync]" in ln for ln in py)
    assert any("// analysis: warning[sync]" in ln for ln in cpp)
    assert (py, cpp) == case(REF)


def test_diagnostic_format_carries_all_fields():
    def case(P):
        d = P.analysis.Diagnostic(
            "error", "race", "kokkos.fused", "m/kokkos.fused(%7)",
            "write-write", "shrink the nest", "map_parallelism")
        err = P.analysis.AnalysisError(diagnostics=(d,))
        assert isinstance(err.diagnostics[0], P.analysis.Diagnostic)
        return d.format(), str(err)
    s, err = case(PORT)
    for tok in ("error", "race", "map_parallelism", "kokkos.fused(%7)",
                "write-write", "shrink the nest"):
        assert tok in s
    assert (s, err) == case(REF)
