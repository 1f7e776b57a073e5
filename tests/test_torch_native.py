"""The port's native oracle: emitted Kokkos C++ built and run on the host.

Each unit the port emits is built with g++ against the executable serial
Kokkos stub (``tests/kokkos_stub``), ctypes-loaded through its C-ABI
harness (``repro_torch.core.native``) and run on the same seeded inputs
as the port's compiled callable (``device="cpu"``) and the reference's
JAX callable: all three agree within 1e-4, the reference's bar
(``tests/test_native_diff.py``).  Shapes are odd (primes, no multiple of
any tile width).  Units whose code lines are equal (they differ only in
``//`` comments, as ``torch`` and ``auto`` do) share one build, so each
distinct unit is built once per session.
"""
import concurrent.futures
import hashlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro_torch.core import native  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402


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


pytestmark = pytest.mark.skipif(native.compiler() is None,
                                reason="no C++ compiler present")

TOL = 1e-4
BACKENDS = ("cuda", "torch", "auto", "loops", "openmp")


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


# ---------------------------------------------------------------------------
# graphs (tests/test_native_diff.py's), for either package
# ---------------------------------------------------------------------------

def _map_graph(ops, rng):
    b = rng.standard_normal((5, 13), dtype=np.float32)

    def fn(x):
        return ops.relu(ops.mul(ops.add(x, ops.constant(b)),
                                ops.constant(b)))
    return fn, (rng.standard_normal((5, 13), dtype=np.float32),)


def _fused_graph(ops, rng):
    w = rng.standard_normal((17, 11), dtype=np.float32)
    b = rng.standard_normal((7, 11), dtype=np.float32)

    def fn(x):
        return ops.softmax(ops.relu(ops.add(ops.matmul(x, ops.constant(w)),
                                            ops.constant(b))))
    return fn, (rng.standard_normal((7, 17), dtype=np.float32),)


def _gemm_graph(ops, rng):
    w = rng.standard_normal((19, 23), dtype=np.float32)

    def fn(x):
        return ops.matmul(x, ops.constant(w))
    return fn, (rng.standard_normal((13, 19), dtype=np.float32),)


def _spmv_graph(ops, rng, ell):
    n = 29
    lens = np.maximum(rng.poisson(3.0, n), 1).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, nnz).astype(np.int32)
    values = rng.standard_normal(nnz).astype(np.float32)
    max_nnz_row = int(lens.max()) if ell else None

    def fn(ip, ind, val, x):
        return ops.relu(ops.spmv_csr(ip, ind, val, x, n_rows=n,
                                     nnz_mean=3.0,
                                     max_nnz_row=max_nnz_row))
    return fn, (indptr, indices, values,
                rng.standard_normal(n).astype(np.float32))


def _paged_copy_graph(ops, rng):
    n_blocks, heads, bs, hd = 7, 3, 4, 5

    def fn(pool, src_ids, dst_ids):
        return ops.page_copy(pool, pool, src_ids, dst_ids, block_size=bs)
    return fn, (rng.standard_normal((n_blocks, heads, bs, hd))
                .astype(np.float32),
                np.array([0, 2, 5], np.int32), np.array([6, 3, 1], np.int32))


def _demo(name):
    def build(ops, rng):
        demos = tpipe._DEMOS if ops is tops else jpipe._DEMOS
        fn, _, example = demos[name]()
        return fn, example
    return build


GRAPHS = {
    "map": _map_graph,
    "fused": _fused_graph,
    "gemm": _gemm_graph,
    "spmv_csr": lambda ops, rng: _spmv_graph(ops, rng, ell=False),
    "spmv_ell": lambda ops, rng: _spmv_graph(ops, rng, ell=True),
    "paged_copy": _paged_copy_graph,
    "demo_mlp": _demo("mlp"),
    "demo_spmv": _demo("spmv"),
    "demo_paged": _demo("paged"),
    "demo_paged_swap": _demo("paged_swap"),
}


def _specs_of(args, spec):
    return [spec(tuple(a.shape), str(a.dtype)) for a in args]


def _port_module(graph, backend):
    fn, args = GRAPHS[graph](tops, _rng(graph))
    mod = tpipe.compile(fn, *_specs_of(args, TensorSpec),
                        options=TOptions(target=backend, device="cpu"),
                        name=graph)
    return mod, args


def _reference_output(graph):
    fn, args = GRAPHS[graph](jops, _rng(graph))
    mod = jpipe.compile(fn, *_specs_of(
        args, lambda s, d: jax.ShapeDtypeStruct(s, d)),
        options=JOptions(target="xla"), name=graph)
    return np.asarray(mod(*args))


def _code_key(text: str) -> str:
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("//"))
    return hashlib.sha256(code.encode()).hexdigest()[:16]


@pytest.fixture(scope="session")
def load(tmp_path_factory):
    """Build and load a compiled module's unit.  Every (graph, backend)
    unit is emitted up front and the distinct ones built four at a time,
    each once per session."""
    root = tmp_path_factory.mktemp("torch_native")
    sources: dict = {}
    for graph in GRAPHS:
        for backend in BACKENDS:
            text = _port_module(graph, backend)[0].emit_cpp_source()
            key = _code_key(text)
            if key not in sources:
                src = root / f"{graph}_{key}.cpp"
                src.write_text(text)
                sources[key] = src
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = dict(zip(sources, pool.map(
            lambda src: native.build_shared(src, root), sources.values())))

    def get(mod):
        return native.NativeModule(built[_code_key(mod.emit_cpp_source())])
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_native_matches_port_and_reference(load, graph, backend):
    mod, args = _port_module(graph, backend)
    nat = load(mod)
    want = mod(*args).numpy()
    got = nat(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _reference_output(graph), atol=TOL,
                               rtol=TOL)


def test_native_takes_tensors(load):
    mod, args = _port_module("spmv_csr", "cuda")
    nat = load(mod)
    tensors = [torch.from_numpy(a) for a in args]
    np.testing.assert_array_equal(nat(*tensors), nat(*args))


def test_native_module_is_reentrant(load):
    mod, args = _port_module("fused", "loops")
    nat = load(mod)
    first = nat(*args)
    for _ in range(3):
        np.testing.assert_array_equal(nat(*args), first)


def test_native_module_validates_inputs(load):
    mod, args = _port_module("gemm", "loops")
    nat = load(mod)
    with pytest.raises(TypeError, match="1 arrays"):
        nat(args[0], args[0])
    with pytest.raises(TypeError, match="expected shape"):
        nat(args[0].T)


def test_descriptor_reports_graph_signature(load):
    mod, args = _port_module("spmv_ell", "loops")
    nat = load(mod)
    assert [s for s, _ in nat.input_specs] == [a.shape for a in args]
    assert [d for _, d in nat.input_specs] == [a.dtype for a in args]
    assert nat.output_spec[0] == tuple(mod(*args).shape)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    mod, _ = _port_module("gemm", "loops")
    monkeypatch.setenv("CXX", "no-such-compiler-lapis")
    assert native.compiler() is None
    with pytest.raises(native.NativeBuildError, match="no C\\+\\+ compiler"):
        native.load_native(mod, tmp_path)


def test_a_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        native.build_shared(bad, tmp_path)


@pytest.mark.parametrize("demo,backend", [("mlp", "cuda"),
                                          ("paged_swap", "openmp")])
def test_cli_run_native(demo, backend, capsys):
    assert tpipe.main(["--demo", demo, "--target", backend, "--device",
                       "cpu", "--run-native"]) == 0
    out = capsys.readouterr().out
    assert "native (executable stub" in out
    diff = float(out.rsplit("max |torch - native| = ", 1)[1].split()[0])
    assert diff <= TOL
