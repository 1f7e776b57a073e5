"""The port's freestanding torch source held to the reference's on the CPU.

``CompiledModule.emit_source`` writes a torch module with the weights
embedded (a base64 npz blob, bf16 / f16 as integers of their width),
library semantics (torch ops and prelude helpers, no hand kernel) and
the compile's device recorded.  On the same seeded numpy inputs it must
agree with the reference's emitted JAX module and with the port's
compiled callable (``device="cpu"``) at 1e-5 in f32: the four demos, the
quickstart model and the reference's fused graphs on every port backend;
ResNet18 at width 0.25 at rtol 1e-4 / atol 1e-5.  The module must run
where neither ``jax`` nor ``repro`` can be imported, and each prelude
helper must equal its ``repro_torch.core.refs`` counterpart.
"""
import dataclasses
import importlib.util
import os
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
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import emitter, refs  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import spmv as tspmv  # noqa: E402
from repro_torch.models import resnet  # noqa: E402


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


ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("cuda", "torch", "auto", "loops", "openmp")
_N = [0]


def _load(src: str, tmp_path, name="gen"):
    """Import emitted source text as a fresh module."""
    _N[0] += 1
    path = tmp_path / f"{name}_{_N[0]}.py"
    path.write_text(src)
    spec = importlib.util.spec_from_file_location(f"{name}_{_N[0]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _code(src: str) -> str:
    """The emitted text without its weight blob: base64 data can spell
    any three letters, ``jax`` included."""
    head, rest = src.split("_WEIGHTS_B64 = (\n", 1)
    return head + rest.split("\n)\n", 1)[1]


def _np(y):
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y)


def _specs(args, spec):
    return [spec(tuple(a.shape), str(a.dtype)) for a in args]


def _jspec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _check(tfn, jfn, args, tmp_path, backends=BACKENDS, rtol=1e-5,
           atol=1e-5, name="fn"):
    """The port's emitted module against its compiled callable and the
    reference's emitted module, on every backend asked."""
    jmod = jpipe.compile(jfn, *_specs(args, _jspec),
                         options=JOptions(target="xla"), name=name)
    # the reference's module takes jax arrays (its paged helpers use .at)
    want = _np(getattr(_load(jmod.emit_source(), tmp_path, "jgen"),
                       name)(*[jax.numpy.asarray(a) for a in args]))
    for backend in backends:
        mod = tpipe.compile(tfn, *_specs(args, TensorSpec), options=TOptions(
            target=backend, device="cpu"), name=name)
        src = mod.emit_source()
        assert "jax" not in _code(src) and "repro" not in _code(src)
        gen = _load(src, tmp_path)
        got = getattr(gen, name)(*args)
        assert got.device.type == "cpu" and gen._DEVICE == "cpu"
        np.testing.assert_allclose(_np(got), _np(mod(*args)), rtol=rtol,
                                   atol=atol, err_msg=backend)
        np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol,
                                   err_msg=backend)
    return src


# ---------------------------------------------------------------------------
# the demos, the quickstart model, the fused graphs, ResNet18
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("demo", ["mlp", "spmv", "paged", "paged_swap"])
def test_demo_source_matches_reference_and_callable(demo, tmp_path):
    tfn, _, args = tpipe._DEMOS[demo]()
    jfn, _, _ = jpipe._DEMOS[demo]()
    atol = 1e-5 if demo in ("mlp", "spmv") else 0.0   # paged: exact copies
    _check(tfn, jfn, args, tmp_path, rtol=atol, atol=atol, name=demo)


def test_quickstart_model_source(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((64, 256), dtype=np.float32) * 0.05
    b1 = rng.standard_normal((8, 256), dtype=np.float32) * 0.05
    w2 = rng.standard_normal((256, 10), dtype=np.float32) * 0.05
    np.testing.assert_array_equal(qs.w1, w1)

    def jmodel(x):
        h = jops.gelu(jops.add(jops.matmul(x, jops.constant(w1)),
                               jops.constant(b1)))
        return jops.softmax(jops.matmul(h, jops.constant(w2)))

    x = np.random.default_rng(9).standard_normal((8, 64)).astype(np.float32)
    _check(qs.model, jmodel, (x,), tmp_path, backends=("cuda", "torch"),
           rtol=1e-5, atol=1e-6, name="model")


def _fused_mlp(ops, rng):
    w1 = rng.standard_normal((16, 32), dtype=np.float32) * 0.3
    b1 = rng.standard_normal((8, 32), dtype=np.float32)
    w2 = rng.standard_normal((32, 4), dtype=np.float32) * 0.3
    b2 = rng.standard_normal((8, 4), dtype=np.float32)

    def fn(x):
        h = ops.gelu(ops.add(ops.matmul(x, ops.constant(w1)),
                             ops.constant(b1)))
        return ops.relu(ops.add(ops.matmul(h, ops.constant(w2)),
                                ops.constant(b2)))
    return fn


def _resnet_block(ops, rng):
    C = 4
    c1 = (rng.standard_normal((C, C, 3, 3)) * 0.1).astype(np.float32)
    c2 = (rng.standard_normal((C, C, 3, 3)) * 0.1).astype(np.float32)
    s = np.abs(rng.standard_normal((2, C))).astype(np.float32) + 0.5
    b = rng.standard_normal((2, C)).astype(np.float32)
    m = rng.standard_normal((2, C)).astype(np.float32)
    v = np.abs(rng.standard_normal((2, C))).astype(np.float32) + 0.5

    def fn(x):
        h = ops.relu(ops.batch_norm_inference(
            ops.conv2d(x, ops.constant(c1)), ops.constant(s[0]),
            ops.constant(b[0]), ops.constant(m[0]), ops.constant(v[0])))
        h = ops.batch_norm_inference(
            ops.conv2d(h, ops.constant(c2)), ops.constant(s[1]),
            ops.constant(b[1]), ops.constant(m[1]), ops.constant(v[1]))
        return ops.relu(ops.add(h, x))
    return fn


@pytest.mark.parametrize("graph", ["mlp", "resnet-block"])
def test_fused_source_round_trip_all_backends(graph, tmp_path):
    build = _fused_mlp if graph == "mlp" else _resnet_block
    tfn = build(tops, np.random.default_rng(0))
    jfn = build(jops, np.random.default_rng(0))
    shape = (8, 16) if graph == "mlp" else (2, 4, 8, 8)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    src = _check(tfn, jfn, (x,), tmp_path)
    assert "# kokkos.fused:" in src          # the region re-emitted


def test_resnet18_source_matches_reference(tmp_path):
    wj = jresnet.init_resnet18_weights(np.random.default_rng(0),
                                       width_mult=0.25)
    wt = convert.from_numpy_tree(wj, "cpu")
    x = np.random.default_rng(1).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)
    src = _check(lambda xx: resnet.resnet18_forward(wt, xx, width_mult=0.25),
                 lambda xx: jresnet.resnet18_forward(wj, xx,
                                                     width_mult=0.25),
                 (x,), tmp_path, backends=("cuda",), rtol=1e-4, atol=1e-5,
                 name="forward")
    assert src.count("= _conv2d(") == 20 and "= _max_pool2d(" in src


# ---------------------------------------------------------------------------
# freestanding, literals, weights, device
# ---------------------------------------------------------------------------

_NO_JAX_NO_REPRO = '''
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "repro", "repro_torch", "jaxlib"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, _Refuse())
sys.path = [p for p in sys.path if not p.rstrip("/").endswith("src")]
import importlib.util, numpy as np
spec = importlib.util.spec_from_file_location("gen", sys.argv[1])
gen = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gen)
gen.lapis_initialize()
x = np.load(sys.argv[2])
np.save(sys.argv[3], gen.mlp(x).numpy())
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro", "repro_torch")))
'''


def test_emitted_module_is_freestanding(tmp_path):
    fn, specs, (x,) = tpipe._demo_mlp()
    mod = tpipe.compile(fn, *specs, options=TOptions(target="cuda",
                                                     device="cpu"))
    src = mod.emit_source()
    assert "jax" not in _code(src) and "repro" not in _code(src)
    assert "lapis_initialize" in src and "_WEIGHTS_B64" in src
    assert "torch.backends" not in src and "set_default" not in src
    imports = sorted(ln for ln in src.splitlines()
                     if ln.startswith(("import ", "from ")))
    assert imports == ["import base64", "import io", "import numpy as np",
                       "import torch", "import torch.nn.functional as F"]
    (tmp_path / "gen.py").write_text(src)
    np.save(tmp_path / "x.npy", x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_NO_REPRO, str(tmp_path / "gen.py"),
         str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), _np(mod(x)),
                               rtol=1e-5, atol=1e-5)


def test_scalar_constants_inlined_as_literals(tmp_path):
    def fn(x):
        return tops.mul(x, tops.constant(np.float32(2.5)))

    x = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
    mod = tpipe.compile(fn, x, options=TOptions(
        target="torch", device="cpu", fuse_elementwise=False))
    src = mod.emit_source()
    assert "torch.tensor(2.5, dtype=torch.float32, device=_device)" in src
    gen = _load(src, tmp_path)
    np.testing.assert_array_equal(_np(gen.fn(x)), x * np.float32(2.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_weights_round_trip_bit_for_bit(dtype, tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((16, 8), generator=g).to(dtype)
    w[0, 0] = float("inf")
    w[0, 1] = -0.0
    host = w.float().numpy().astype(np.float16) if dtype == torch.float16 \
        else None
    for value in (w, host):
        if value is None:
            continue

        def fn(x, _w=value):
            return tops.matmul(x, tops.constant(_w))
        mod = tpipe.compile(fn, TensorSpec((4, 16), str(dtype).split(".")[1]),
                            options=TOptions(target="torch", device="cpu"))
        src = mod.emit_source()
        name = str(dtype).split(".")[1]
        assert f"_WEIGHT_DTYPES = {{'w0': '{name}'}}" in src
        gen = _load(src, tmp_path)
        gen.lapis_initialize()
        got = gen._WEIGHTS["w0"]
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.int16), w.view(torch.int16))
        x = torch.randn((4, 16), generator=g).to(dtype)
        assert torch.equal(gen.fn(x), mod(x))


def test_initialize_is_idempotent_and_finalize_clears(tmp_path):
    fn, specs, (x,) = tpipe._demo_mlp()
    mod = tpipe.compile(fn, *specs, options=TOptions(target="cuda",
                                                     device="cpu"))
    gen = _load(mod.emit_source(), tmp_path)
    assert gen._WEIGHTS == {} and not gen._initialized
    gen.lapis_initialize()
    first = dict(gen._WEIGHTS)
    assert sorted(first) == ["w0", "w1", "w2"]
    gen.lapis_initialize()
    gen.lapis_initialize(device="cpu")
    assert all(gen._WEIGHTS[k] is first[k] for k in first)   # no reload
    y = gen.mlp(x)
    assert all(gen._WEIGHTS[k] is first[k] for k in first)
    gen.lapis_finalize()
    assert gen._WEIGHTS == {} and not gen._initialized
    torch.testing.assert_close(gen.mlp(x), y, rtol=0, atol=0)


def test_module_records_the_compiles_device(tmp_path):
    """A module compiled for the card loads its weights there by default
    and raises without one; it never carries on on the CPU, unless the
    caller names the CPU."""
    fn, specs, (x,) = tpipe._demo_mlp()
    mod = tpipe.compile(fn, *specs, options=TOptions(target="cuda",
                                                     device="cpu"))
    card = emitter.emit_python_source(
        mod.graph, dataclasses.replace(mod.options, device="cuda"))
    assert "_DEVICE = 'cuda'" in card
    assert "_DEVICE = 'cpu'" in mod.emit_source()
    gen = _load(card, tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            gen.lapis_initialize()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            gen.mlp(x)
        assert not gen._initialized
    gen.lapis_initialize(device="cpu")
    assert all(w.device.type == "cpu" for w in gen._WEIGHTS.values())
    np.testing.assert_allclose(_np(gen.mlp(x)), _np(mod(x)), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="input on meta"):
        gen.mlp(torch.empty((8, 64), device="meta"))


# ---------------------------------------------------------------------------
# the prelude's helpers are copies of the refs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prelude():
    ns: dict = {}
    exec(compile(emitter._PRELUDE, "<prelude>", "exec"), ns)
    return ns


def _t(rng, *shape, dtype=np.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_prelude_dense_helpers_equal_refs(prelude, rng):
    p = prelude
    a, b = _t(rng, 3, 5), _t(rng, 5, 4)
    _same(p["_matmul"](a, b.double()), refs.matmul(a, b.double()))
    for x, y in ((a, b), (a, _t(rng, 5)), (a, torch.tensor(2.0)),
                 (_t(rng, 2, 3, 5), _t(rng, 4, 5, 6))):
        _same(p["_dot"](x, y), refs.dot(x, y))
    _same(p["_softmax"](a, 0), refs.softmax(a, 0))
    ints = torch.from_numpy(rng.integers(-5, 5, (3, 4)).astype(np.int32))
    for x in (a, ints, ints > 0):
        for axis in (None, 0, (0, 1), -1):
            for keep in (False, True):
                _same(p["_reduce_sum"](x, axis, keep),
                      refs.reduce_sum(x, axis, keep))
                _same(p["_mean"](x, axis, keep), refs.mean(x, axis, keep))
                if x.dtype != torch.bool:
                    _same(p["_reduce_max"](x, axis, keep),
                          refs.reduce_max(x, axis, keep))
    c = _t(rng, 2, 3, 4)
    for perm in (None, (1, 0, 2), (2, 0, 1)):
        _same(p["_transpose"](c, perm), refs.transpose(c, perm))
    for starts in ((0, 0, 0), (-1, 2, 1), (5, -9, 3)):
        _same(p["_dynamic_slice"](c, starts, (1, 2, 2)),
              refs.dynamic_slice(c, starts, (1, 2, 2)))
    pads = ((1, 0), (0, 2), (3, 1))
    _same(p["_pad"](c, pads, 1.5), refs.pad(c, pads, 1.5))
    idx = torch.tensor([[0, -1], [7, 2]], dtype=torch.int32)
    for axis in (0, 1, -1):
        _same(p["_take"](c, idx, axis), refs.take(c, idx, axis))
    _same(p["_take"](ints, idx, 1), refs.take(ints, idx, 1))
    x = _t(rng, 2, 3, 9, 10)
    w = _t(rng, 4, 3, 3, 3)
    for stride, padding in (((1, 1), "SAME"), ((2, 2), "SAME"),
                            ((2, 1), "VALID"), ((1, 2), ((1, 0), (2, 1)))):
        assert p["_same_pads"](9, 3, stride[0]) == \
            refs.same_pads(9, 3, stride[0])
        _same(p["_conv2d"](x, w, stride, padding),
              refs.conv2d(x, w, stride, padding))
        _same(p["_max_pool2d"](x, (3, 3), stride, padding),
              refs.max_pool2d(x, (3, 3), stride, padding))
    s, bb, m, v = (_t(rng, 3) for _ in range(4))
    _same(p["_batch_norm"](x, s, bb, m, v.abs(), eps=1e-3),
          refs.batch_norm(x, s, bb, m, v.abs(), eps=1e-3))


def test_prelude_sparse_and_paged_helpers_equal_the_plain_versions(
        prelude, rng):
    p = prelude
    n, n_cols = 11, 7
    lens = rng.integers(0, 4, n)
    lens[-2:] = 0                                     # trailing empty rows
    ip = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(
        np.int32))
    nnz = int(ip[-1])
    ind = torch.from_numpy(rng.integers(0, n_cols, nnz).astype(np.int32))
    val = _t(rng, nnz)
    x, bm = _t(rng, n_cols), _t(rng, n_cols, 3)
    csr = tspmv.CsrMatrix(ip, ind, val, n, n_cols)
    pcsr = p["_sparse_pack"](ip, ind, val, n, n_cols)
    _same(p["_spmv"](pcsr, x), tspmv.spmv_reference(csr, x))
    _same(p["_spmm"](pcsr, bm), tspmv.spmm_reference(csr, bm))
    for mx in (3, 9):
        ell = tspmv.as_ell(csr, max_nnz_row=mx)
        pell = p["_sparse_convert"](pcsr, mx)
        _same(pell[1:4], (ell.values, ell.indices, ell.valid))
        _same(p["_spmv"](pell, x), tspmv.spmv_reference(ell, x))
        _same(p["_spmm"](pell, bm), tspmv.spmm_reference(ell, bm))
    from repro_torch.core import ops as core_ops
    pool = _t(rng, 9, 2, 4, 3)
    table = torch.tensor([[1, 2], [3, 8], [0, 5]], dtype=torch.int32)
    lengths = torch.tensor([5, 0, 7], dtype=torch.int32)
    kv = _t(rng, 3, 2, 3)
    _same(p["_page_gather"](pool, table, lengths),
          core_ops._page_gather_ref(4)(pool, table, lengths))
    _same(p["_page_append"](pool, table, lengths, kv, 4),
          core_ops._page_append_ref(4)(pool, table, lengths, kv))
    src_ids = torch.tensor([1, 4], dtype=torch.int32)
    dst_ids = torch.tensor([6, 0], dtype=torch.int32)
    for dst in (pool, _t(rng, 2, 9, 2, 4, 3)):
        src = torch.flip(dst, dims=(0,))
        _same(p["_page_copy"](dst, src, src_ids, dst_ids),
              core_ops._page_copy_ref(4)(dst, src, src_ids, dst_ids))
