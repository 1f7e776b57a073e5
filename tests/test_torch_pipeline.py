"""The port's compiler main path held to the JAX reference on the CPU.

The same seeded numpy inputs and weights go through
``repro.core.pipeline.compile`` (JAX) and ``repro_torch.core.pipeline
.compile`` (torch, ``device="cpu"``, so every kernel wrapper runs its
plain version): the IR after every pass, the outputs (1e-5 in f32) and
the launch counts must agree.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.models.mlp import apply_gated_mlp, gated_mlp_spec  # noqa: E402
from repro.models.spec import init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import generic, matmul as tmm  # noqa: E402
from repro_torch.models.mlp import gated_mlp_block  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D, D_FF, T = 64, 128, 16


def _ids_normalized(text: str) -> str:
    """SSA value ids come from a process-wide counter in each package;
    renumber them by first appearance so the two dumps compare."""
    ids = {}
    return re.sub(r"%(\d+)", lambda m: "%" + ids.setdefault(
        m.group(1), f"v{len(ids)}"), text)


def _ref_params():
    p = init_params(gated_mlp_spec(D, D_FF), jax.random.PRNGKey(0))
    return {k: np.asarray(jax.device_get(v)) for k, v in p.items()}


def _ref_block(p):
    def qwen2_mlp_block(x):
        g = jops.silu(jops.matmul(x, p["w_gate"]))
        u = jops.matmul(x, p["w_up"])
        return jops.add(jops.matmul(jops.mul(g, u), p["w_down"]), x)
    return qwen2_mlp_block


def _port_block(p):
    def qwen2_mlp_block(x):
        return gated_mlp_block(p, x)
    return qwen2_mlp_block


def _x():
    return np.random.default_rng(3).standard_normal((T, D)).astype(
        np.float32)


def _dump(compile_fn, fn, specs, options, capsys):
    compile_fn(fn, *specs, options=options)
    return _ids_normalized(capsys.readouterr().out)


@pytest.mark.parametrize("case", ["mlp_demo", "qwen2_block", "spmv_demo",
                                  "paged_demo", "paged_swap_demo"])
def test_ir_after_every_pass_matches_reference_on_loops(case, capsys):
    if case.endswith("_demo"):
        demo = case[:-len("_demo")]
        jfn, jspecs, _ = jpipe._DEMOS[demo]()
        tfn, tspecs, _ = tpipe._DEMOS[demo]()
    else:
        p = _ref_params()
        jfn, tfn = _ref_block(p), _port_block(
            convert.from_numpy_tree(p, "cpu"))
        jspecs = [jax.ShapeDtypeStruct((T, D), "float32")]
        tspecs = [TensorSpec((T, D), "float32")]
    ref = _dump(jpipe.compile, jfn, jspecs,
                JOptions(target="loops", print_ir_after_all=True), capsys)
    port = _dump(tpipe.compile, tfn, tspecs,
                 TOptions(target="loops", device="cpu",
                          print_ir_after_all=True), capsys)
    assert ref.count("// ----- IR after") == 7
    assert port == ref


def _reset_counts():
    for w in (tmm.matmul, generic.block_map_region, generic.row_softmax):
        w.launches = w.plain_calls = 0


@pytest.mark.parametrize("ref_target", ["pallas", "xla"])
def test_mlp_demo_matches_reference(ref_target):
    jfn, jspecs, (ex,) = jpipe._demo_mlp()
    tfn, tspecs, _ = tpipe._demo_mlp()
    jmod = jpipe.compile(jfn, *jspecs, options=JOptions(
        target=ref_target, interpret=True))
    _reset_counts()
    tmod = tpipe.compile(tfn, *tspecs,
                         options=TOptions(target="cuda", device="cpu"))
    want = np.asarray(jmod(ex))
    got = tmod(ex).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tmod.launch_count == jmod.launch_count == 4
    # on the CPU every kernel wrapper took its plain version
    assert (tmm.matmul.plain_calls, generic.block_map_region.plain_calls,
            generic.row_softmax.plain_calls) == (2, 1, 1)
    assert tmm.matmul.launches == generic.block_map_region.launches == 0


@pytest.mark.parametrize("ref_target", ["pallas", "xla"])
def test_reduced_qwen2_block_matches_reference(ref_target):
    p = _ref_params()
    x = _x()
    jmod = jpipe.compile(_ref_block(p), jax.ShapeDtypeStruct((T, D),
                                                             "float32"),
                         options=JOptions(target=ref_target, interpret=True))
    tmod = tpipe.compile(_port_block(convert.from_numpy_tree(p, "cpu")),
                         TensorSpec((T, D), "float32"),
                         options=TOptions(target="cuda", device="cpu"))
    got = tmod(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod(x)), rtol=1e-5,
                               atol=1e-5)
    assert tmod.launch_count == jmod.launch_count == 5
    # … and the block is the reference model's own gated MLP plus x
    want = np.asarray(apply_gated_mlp(p, x) + x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_launches_are_three_gemms_and_two_nests():
    p = convert.from_numpy_tree(_ref_params(), "cpu")
    mod = tpipe.compile(_port_block(p), TensorSpec((T, D), "float32"),
                        options=TOptions(target="cuda", device="cpu"))
    launched = [op for op in mod.graph.ops
                if op.opname not in ("tensor.constant", "kokkos.sync",
                                     "kokkos.modify")]
    assert [op.opname for op in launched] == [
        "kk.gemm", "kk.gemm", "kokkos.team_parallel", "kk.gemm",
        "kokkos.team_parallel"]
    fused, add = launched[2], launched[4]
    assert fused.attrs["ops"] == ("linalg.silu", "linalg.mul")
    assert add.attrs["src"] == "linalg.add" and not add.regions
    assert all(not op.attrs.get("collapse") for op in launched)


def test_cli_demo_prints_reference_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TUNE_CACHE=os.environ["REPRO_TUNE_CACHE"])
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.pipeline", "--demo", "mlp",
         "--target", "cuda", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == \
        "output shape: (8, 10) sum: 8.0"


def test_convert_carries_bf16_and_f32_leaves():
    tree = {"w_up": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": [np.asarray(jax.numpy.asarray(
                [1.5, -2.0, 3.25], dtype=jax.numpy.bfloat16))]}
    out = convert.from_numpy_tree(tree, "cpu")
    assert out["w_up"].dtype == torch.float32
    assert out["w_up"].tolist() == [[0, 1, 2], [3, 4, 5]]
    bf = out["nested"][0]
    assert isinstance(out["nested"], list) and bf.dtype == torch.bfloat16
    assert bf.float().tolist() == [1.5, -2.0, 3.25]


def _power_of_product(o):
    return lambda x, w: o.power(o.matmul(x, w), 2.0)


def test_unfused_power_compiles_for_cuda_and_matches_reference():
    """The power after a product fuses with nothing, so it lowers to a
    one-op nest; on ``cuda`` that nest's kernel is generated (its source
    spells the exponent) and, on CPU tensors, dispatch runs its plain
    version, equal to the reference's ``xla`` result."""
    from repro_torch.core import ops as tops
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    mod = tpipe.compile(_power_of_product(tops),
                        TensorSpec((8, 16), "float32"),
                        TensorSpec((16, 4), "float32"),
                        options=TOptions(target="cuda", device="cpu"))
    (nest,) = [op for op in mod.graph.ops
               if op.opname == "kokkos.team_parallel"]
    assert nest.attrs["src"] == "linalg.power" and not nest.regions
    assert any("powf(x[0], 2.0f)" in ks.source
               for ks in kops.kernel_sources(mod.graph))
    before = generic.block_map_region.plain_calls
    got = mod(torch.from_numpy(x), torch.from_numpy(w))
    assert generic.block_map_region.plain_calls == before + 1
    jmod = jpipe.compile(_power_of_product(jops),
                         jax.ShapeDtypeStruct((8, 16), np.float32),
                         jax.ShapeDtypeStruct((16, 4), np.float32),
                         options=JOptions(target="xla"))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmod(x, w)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes", [((4, 5), (5, 3)), ((4, 5), (5,)),
                                    ((3, 4, 5), (3, 5, 2))],
                         ids=["matmul", "gemv", "batched"])
def test_eager_kernel_ops_on_cpu_tensors_match_reference(shapes):
    """Eager ``ops.matmul`` / ``ops.gemv`` / batched ``ops.matmul`` with
    the default options (``target="auto"``, ``device="cuda"``) on CPU
    tensors run on the CPU, as the reference runs on any host."""
    from repro_torch.core import ops as tops
    from repro_torch.core.options import current_options
    assert current_options().device == "cuda"
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    fn = "gemv" if len(shapes[1]) == 1 else "matmul"
    got = getattr(tops, fn)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(getattr(jops, fn)(a, b)),
                               rtol=1e-5, atol=1e-5)


def test_eager_kernel_ops_on_mixed_devices_raise():
    """Operands on two devices (``meta`` stands in for the card) raise
    before any implementation is chosen; a lone non-CPU device goes to
    the card's selection, never to the CPU's library."""
    from repro_torch.core import ops as tops
    cpu, meta = torch.zeros(4, 5), torch.empty((5, 3), device="meta")
    with pytest.raises(ValueError, match="one device"):
        tops.matmul(cpu, meta)
    with pytest.raises(ValueError, match="one device"):
        tops.gemv(cpu, torch.empty((5,), device="meta"))
    assert TOptions(device="cpu").for_tensors([cpu]).device == "cpu"
    assert TOptions(device="cpu").for_tensors([3.0]).device == "cpu"
    assert TOptions().for_tensors([cpu, cpu]).device == "cpu"
