"""The port's backend subsystem held to the JAX reference on the CPU.

The cases of the reference's ``tests/test_backend.py`` through both
packages: registration and its idempotence, unknown-backend errors,
fallback order, the ``loops`` plugin backend, ``PassManager``
statistics, IR dumps and verification.  Then the library interception
the paper's ``auto`` pipeline makes (``CompileOptions.prefer_library``,
``LIBRARY_PREFERRED``): ``select_target`` gives the reference's answer
(``xla`` → ``torch``, ``pallas`` → ``cuda``) for every op, target,
``prefer_library`` and device.  The reference's kernels on a host
without a TPU run in interpret mode; the port's counterpart of that
mode is the card's options (``_on_card`` patched to true here), and the
port has no ``interpret``: its plain versions run under
``target="cuda", device="cpu"``.
"""
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.backends import builtin  # noqa: E402
from repro_torch.kernels import generic, matmul as tmm  # noqa: E402
from test_torch_analysis import (PKGS, PORT, REF,  # noqa: E402
                                 ids_normalized)

_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def scratch_registry(monkeypatch):
    """Both packages' backend and kernel tables as copies for the test:
    a throwaway backend registered here leaves no trace."""
    for P in PKGS:
        b = P.backend
        b.available_targets("kk.gemm")     # every kernel module loaded first
        monkeypatch.setattr(b, "_BACKENDS", dict(b._BACKENDS))
        monkeypatch.setattr(b, "_KERNELS",
                            {k: dict(v) for k, v in b._KERNELS.items()})


# ---------------------------------------------------------------------------
# registration + fallback order
# ---------------------------------------------------------------------------

def test_builtin_and_plugin_backends_registered():
    names = PORT.backend.available_backends()
    assert {"auto", "torch", "cuda", "loops", "openmp"} <= set(names)
    assert sorted(REF.target(n) for n in names) == \
        REF.backend.available_backends()


def test_unknown_backend_error_lists_available():
    with pytest.raises(PORT.backend.UnknownBackendError) as e:
        PORT.backend.resolve("cuda-raytracer")
    assert "torch" in str(e.value) and "cuda" in str(e.value)


def test_registration_is_idempotent():
    b = PORT.backend
    before = b.available_targets("kk.gemm")
    b.load_plugins()
    b.load_plugins()
    assert b.available_targets("kk.gemm") == before
    loops = b.get_backend("loops")
    b.register_backend(loops)
    assert b.available_backends().count("loops") == 1


def test_plugin_backend_fallback_order(scratch_registry):
    def case(P, fallback):
        calls = []
        P.backend.register_backend(P.backend.Backend(
            name="dummy-test", fallbacks=(fallback,),
            pipeline=P.backend.DEFAULT_PIPELINE))
        P.backend.register_kernel(
            "kk.gemm", "dummy-test",
            lambda a, b, tiling=None: calls.append("hit") or a @ b)
        opts = P.options.CompileOptions(target="dummy-test")
        picked = P.registry.select_target("kk.gemm", opts)
        a = np.eye(3, dtype=np.float32)
        P.registry.dispatch("kk.gemm", opts)(a, a)
        return picked, calls, P.registry.select_target("kk.spmv", opts)
    assert case(PORT, "torch") == ("dummy-test", ["hit"], "torch")
    assert case(REF, "xla") == ("dummy-test", ["hit"], "xla")


def test_available_targets_includes_plugin():
    for op in ("kk.gemm", "kk.spmv", "kokkos.page_gather"):
        got = PORT.backend.available_targets(op)
        assert sorted(REF.target(t) for t in got) == \
            REF.backend.available_targets(op)
    assert {"loops", "cuda", "torch"} <= set(
        PORT.backend.available_targets("kk.gemm"))


# ---------------------------------------------------------------------------
# library interception: prefer_library and LIBRARY_PREFERRED
# ---------------------------------------------------------------------------

def test_library_preferred_is_the_references():
    assert PORT.backend.LIBRARY_PREFERRED == REF.backend.LIBRARY_PREFERRED \
        == {"kk.gemm", "kk.gemv", "kk.batched_gemm", "kk.conv2d"}
    assert PORT.registry.LIBRARY_PREFERRED is PORT.backend.LIBRARY_PREFERRED
    assert PORT.options.CompileOptions().prefer_library is True
    assert PORT.options.CompileOptions().target == "auto"


def test_select_target_parity_explicit_targets():
    assert PORT.registry.select_target(
        "kk.gemm", PORT.opts("torch")) == "torch"
    assert PORT.registry.select_target(
        "kk.gemm", PORT.opts("cuda")) == "cuda"


def test_select_target_parity_auto_cpu_stays_on_library():
    opts = PORT.opts("auto")
    for op in ("kk.gemm", "kk.rwkv6_scan", "kk.spmv"):
        assert PORT.registry.select_target(op, opts) == "torch"
        assert REF.registry.select_target(
            op, REF.options.CompileOptions(target="auto")) == "xla"


@pytest.fixture
def on_card(monkeypatch):
    """The port's auto selector as it runs on the card."""
    monkeypatch.setattr(builtin, "_on_card", lambda options: True)


def test_select_target_parity_auto_on_card_prefers_library_ops(on_card):
    opts = PORT.options.CompileOptions(target="auto")     # device="cuda"
    assert PORT.registry.select_target("kk.gemm", opts) == "torch"
    assert PORT.registry.select_target("kk.rwkv6_scan", opts) == "cuda"
    opts2 = PORT.options.CompileOptions(target="auto", prefer_library=False)
    assert PORT.registry.select_target("kk.gemm", opts2) == "cuda"


def _all_ops() -> list:
    """Every op either package registers a kernel for (every kernel
    module loaded first)."""
    for P in PKGS:
        P.backend.available_targets("kk.gemm")
    return sorted(set(REF.backend._KERNELS) | set(PORT.backend._KERNELS))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("prefer_library", [True, False])
@pytest.mark.parametrize("target", ["auto", "torch", "cuda"])
def test_select_target_matches_reference_for_every_op(
        target, prefer_library, device, monkeypatch):
    """Every op the packages register: the port picks what the reference
    picks, renamed.  ``device="cuda"`` (the card; ``_on_card`` patched)
    corresponds to the reference's kernels reachable off a TPU
    (``interpret=True``); ``device="cpu"`` to its default off a TPU."""
    if device == "cuda":
        monkeypatch.setattr(builtin, "_on_card", lambda options: True)
    port_opts = PORT.options.CompileOptions(
        target=target, device=device, prefer_library=prefer_library)
    ref_opts = REF.options.CompileOptions(
        target=REF.target(target), prefer_library=prefer_library,
        interpret=True if device == "cuda" else None)
    all_ops = _all_ops()
    assert "kk.gemm" in all_ops and "kokkos.page_gather" in all_ops
    for op in all_ops:
        got = PORT.registry.select_target(op, port_opts)
        want = REF.registry.select_target(op, ref_opts)
        assert REF.target(got) == want, \
            (op, got, want)
    if target == "auto" and device == "cuda":
        gemm = PORT.registry.select_target("kk.gemm", port_opts)
        assert gemm == ("torch" if prefer_library else "cuda")


def test_no_interpret_the_plain_versions_run_under_cuda_on_the_cpu():
    """A difference, pinned: the reference's ``auto`` + ``interpret=True``
    off a TPU takes its kernels (interpreted); the port has no
    ``interpret``, so ``auto`` on the CPU stays on the library whatever
    ``prefer_library`` says, and the kernels' plain versions run under
    ``target="cuda", device="cpu"``, where every op with a kernel picks
    it, as the reference's ``auto`` + ``interpret`` +
    ``prefer_library=False`` does."""
    assert not hasattr(PORT.options.CompileOptions(), "interpret")
    ref_opts = REF.options.CompileOptions(target="auto", interpret=True,
                                          prefer_library=False)
    for op in _all_ops():
        assert PORT.registry.select_target(op, PORT.opts(
            "auto", prefer_library=False)) == "torch"
        assert REF.target(PORT.registry.select_target(
            op, PORT.opts("cuda"))) == \
            REF.registry.select_target(op, ref_opts)


def _mlp(rng):
    w1 = rng.standard_normal((16, 32), dtype=np.float32)
    w2 = rng.standard_normal((32, 4), dtype=np.float32)

    def fn_of(ops):
        def fn(x):
            return ops.softmax(ops.matmul(ops.relu(ops.matmul(
                x, ops.constant(w1))), ops.constant(w2)))
        return fn

    def ref(x):
        h = np.maximum(x @ w1, 0)
        z = h @ w2
        e = np.exp(z - z.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    return fn_of, ref


def test_kernel_target_executable_without_library_interception():
    """``tests/test_emitter.py``'s kernel case: ``prefer_library=False``,
    no fusion; the reference's ``pallas`` (interpret) against the port's
    ``cuda`` on the CPU (the plain versions), each within 1e-4 of numpy
    and 1e-5 of each other."""
    rng = np.random.default_rng(0)
    fn_of, ref = _mlp(rng)
    x = rng.standard_normal((8, 16), dtype=np.float32)
    kw = dict(prefer_library=False, fuse_elementwise=False)
    jmod = REF.pipeline.compile(fn_of(REF.ops), x,
                                options=REF.opts("cuda", **kw))
    for w in (tmm.matmul, generic.block_map_region, generic.row_softmax):
        w.launches = w.plain_calls = 0
    tmod = PORT.pipeline.compile(fn_of(PORT.ops), x,
                                 options=PORT.opts("cuda", **kw))
    assert "kokkos.team_parallel" in [op.opname for op in tmod.graph.ops]
    got = tmod(x).numpy()
    np.testing.assert_allclose(got, ref(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jmod(x)), **_TOL)
    assert tmod.launch_count == jmod.launch_count
    assert (tmm.matmul.plain_calls, generic.block_map_region.plain_calls,
            generic.row_softmax.plain_calls) == (2, 1, 1)
    assert tmm.matmul.launches == 0


def test_auto_collapses_nests_as_the_reference_does(on_card):
    """``auto`` declares no ``loop-nests``, in both packages: its nests
    are collapsed into one library call each and its products go to the
    library while ``prefer_library``; the port's IR is the reference's
    under the same hierarchy."""
    fn_of, _ = _mlp(np.random.default_rng(0))
    hier = PORT.backend.get_backend("auto").hierarchy.to_dict()
    graphs = [P.pipeline.compile(fn_of(P.ops), P.spec((8, 16), "float32"),
                                 options=P.opts("auto", hierarchy=hier)).graph
              for P in PKGS]
    assert ids_normalized(str(graphs[1])) == ids_normalized(str(graphs[0]))
    nests = [op for op in graphs[1].ops if op.opname.startswith("kokkos.")
             and op.opname.endswith("_parallel")]
    assert nests and all(op.attrs["collapse"] for op in nests)
    opts = PORT.options.CompileOptions(target="auto")
    assert [PORT.registry.select_target(op.opname, opts)
            for op in graphs[1].ops if op.opname == "kk.gemm"] == \
        ["torch", "torch"]


# ---------------------------------------------------------------------------
# per-backend parallelism mapping (one pipeline, per-backend hierarchies)
# ---------------------------------------------------------------------------

def test_unified_pipeline_mapping_library_vs_loop_backends():
    for name in ("torch", "cuda", "loops", "auto", "openmp"):
        assert PORT.backend.get_backend(name).pipeline == \
            PORT.backend.DEFAULT_PIPELINE == REF.backend.DEFAULT_PIPELINE

    def mapped(P, target):
        g = P.trace(lambda x: P.ops.relu(x), (64, 256))
        with P.options.use_options(P.opts(target)) as o:
            P.passes.run_pipeline(g, o)
        (nest,) = [op for op in g.ops if op.opname == "kokkos.team_parallel"]
        return nest
    assert mapped(PORT, "torch").attrs["collapse"]
    nest2 = mapped(PORT, "loops")
    assert not nest2.attrs.get("collapse")
    assert nest2.attrs["exec_space"] == "host"
    assert nest2.attrs["level_map"] == ("serial-block", "jnp-vector")
    assert nest2.attrs["tiling"] == mapped(REF, "loops").attrs["tiling"]


# ---------------------------------------------------------------------------
# PassManager: statistics shape, verification, IR dumps
# ---------------------------------------------------------------------------

def test_passmanager_statistics_shape():
    def case(P):
        ops = P.ops
        g = P.trace(lambda x, y: ops.softmax(ops.matmul(ops.relu(x), y)),
                    (16, 32), (32, 64))
        P.passes.run_pipeline(g, P.opts("torch"))
        assert g.pipeline_stats["linalg_to_library"] == 1
        names = [s.name for s in g.pass_stats]
        assert names == list(P.backend.get_backend(
            P.target("torch")).pipeline)
        for stat in g.pass_stats:
            assert stat.rewrites >= 0
            assert stat.seconds >= 0.0
            assert stat.ops_before >= 0 and stat.ops_after >= 0
        return [(s.name, s.rewrites, s.ops_before, s.ops_after)
                for s in g.pass_stats]
    assert case(PORT) == case(REF)


def test_passmanager_print_ir_after_all_sink():
    def case(P):
        g = P.trace(lambda x, y: P.ops.matmul(x, y), (3, 4), (4, 5))
        dumped = []
        pm = P.passmgr.PassManager(("linalg_to_library",), verify="full",
                                   print_ir_after_all=True,
                                   sink=dumped.append)
        pm.run(g, P.opts("torch"))
        return ids_normalized("\n".join(dumped))
    dump = case(PORT)
    assert "IR after linalg_to_library" in dump and "kk.gemm" in dump
    assert dump == case(REF)


def test_passmanager_verify_catches_ssa_violation():
    ir = PORT.ir
    t = ir.TensorType((2,), "float32")
    x, orphan = ir.Value(t), ir.Value(t)
    g = ir.Graph("bad", [x])
    bad = ir.Op("linalg.relu", [orphan], [t])
    g.add(bad)
    g.outputs = [bad.results[0]]
    with pytest.raises(PORT.passmgr.IRVerificationError):
        PORT.passmgr.verify_graph(g)
    ok = PORT.trace(lambda a, b: PORT.ops.matmul(a, b), (3, 4), (4, 5))
    PORT.passmgr.PassManager(("linalg_to_library",), verify=True).run(
        ok, PORT.opts("torch"))


# ---------------------------------------------------------------------------
# `loops` reference backend (registered purely via the plugin API)
# ---------------------------------------------------------------------------

def test_loops_backend_matches_library():
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((64, 128), dtype=np.float32)
    w2 = rng.standard_normal((128, 10), dtype=np.float32)
    x = rng.standard_normal((8, 64)).astype(np.float32)

    def run(P, target):
        ops = P.ops

        def fn(v):
            h = ops.relu(ops.matmul(v, ops.constant(w1)))
            return ops.softmax(ops.matmul(h, ops.constant(w2)))
        y = P.pipeline.compile(fn, P.spec((8, 64), "float32"),
                               options=P.opts(target))(x)
        return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    y_lib = run(PORT, "torch")
    np.testing.assert_allclose(run(PORT, "loops"), y_lib, **_TOL)
    np.testing.assert_allclose(y_lib, run(REF, "torch"), **_TOL)
    np.testing.assert_allclose(run(PORT, "loops"), run(REF, "loops"), **_TOL)


def test_loops_backend_not_hardcoded_in_core():
    core = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch"
    offenders = []
    for path in core.rglob("*.py"):
        if "backends" in path.parts:
            continue                       # the backend layer itself
        text = path.read_text()
        if "options.target ==" in text or "options.target !=" in text:
            offenders.append(str(path))
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# CLI plumbing
# ---------------------------------------------------------------------------

def test_cli_list_backends(capsys):
    assert PORT.pipeline.main(["--list-backends"]) == 0
    out = capsys.readouterr().out
    for name in ("auto", "torch", "cuda", "loops", "openmp"):
        assert name in out
    assert "library for hand-optimized ops" in out


def test_cli_demo_on_loops_backend(capsys):
    assert PORT.pipeline.main(["--demo", "mlp", "--target", "loops",
                               "--device", "cpu"]) == 0
    assert "output shape: (8, 10)" in capsys.readouterr().out
