"""The port's lapis-translate held to the reference's on the CPU.

The four pinned graphs of the reference's ``tests/test_translate.py``
are built twice from the same seeded weights: through ``repro`` (JAX)
and through ``repro_torch`` (``device="cpu"``).  On the host backends
(``loops``, ``openmp``) the port's Kokkos C++ unit must be the
reference's golden byte for byte.  On the port's device backends
(``cuda``, ``torch``, ``auto``) the unit must be byte-deterministic and
equal, in every line that is not a ``//`` comment, to the reference's
unit of the same layout emitted live: the mapped nests of ``pallas`` for
``cuda`` (``xla``'s CSR row loop for its spmv: ``cuda`` declares no
``ell-layout``), the collapsed library nests of ``xla`` for ``torch``
and ``auto``.  The comments differ by design (backend name, hierarchy
level names, H100 tilings and costs).  Every unit must pass ``g++
-std=c++17 -fsyntax-only`` against ``tests/kokkos_stub``.  Each
(graph, backend) unit is emitted once per session.
"""
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro_torch.core import backend as backend_mod  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import translate  # noqa: E402
from repro_torch.core.ir import Graph, Op, TensorType, Value  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden" / "translate"
STUB_DIR = pathlib.Path(__file__).parent / "kokkos_stub"
GXX = shutil.which("g++")

HOST = ("loops", "openmp")
DEVICE = ("cuda", "torch", "auto")
BACKENDS = DEVICE + HOST


def _jspec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


# ---------------------------------------------------------------------------
# the pinned graphs (tests/test_translate.py), for either package
# ---------------------------------------------------------------------------

def _matmul_graph(ops, spec):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((16, 8), dtype=np.float32)

    def fn(x):
        return ops.matmul(x, ops.constant(w))
    return fn, (spec((4, 16), "float32"),)


def _fused_mlp_graph(ops, spec):
    rng = np.random.default_rng(11)
    w1 = rng.standard_normal((16, 32), dtype=np.float32)
    b1 = rng.standard_normal((4, 32), dtype=np.float32)
    w2 = rng.standard_normal((32, 8), dtype=np.float32)

    def fn(x):
        h = ops.relu(ops.add(ops.matmul(x, ops.constant(w1)),
                             ops.constant(b1)))
        return ops.softmax(ops.matmul(h, ops.constant(w2)))
    return fn, (spec((4, 16), "float32"),)


def _spmv_graph(ops, spec):
    n, nnz, max_nnz_row = 8, 12, 2

    def fn(ip, ind, val, x):
        return ops.relu(ops.spmv_csr(ip, ind, val, x, n_rows=n,
                                     nnz_mean=1.5,
                                     max_nnz_row=max_nnz_row))
    return fn, (spec((n + 1,), "int32"), spec((nnz,), "int32"),
                spec((nnz,), "float32"), spec((n,), "float32"))


def _paged_swap_graph(ops, spec):
    n_blocks, n_swap, heads, bs, hd = 9, 5, 2, 4, 8

    def fn(pool, swap, pool_ids, swap_ids, fresh_ids):
        swap2 = ops.page_swap_out(swap, pool, pool_ids, swap_ids,
                                  block_size=bs)
        pool2 = ops.page_swap_in(pool, swap2, swap_ids, fresh_ids,
                                 block_size=bs)
        return ops.page_copy(pool2, pool2, fresh_ids, pool_ids,
                             block_size=bs)
    return fn, (spec((n_blocks, heads, bs, hd), "float32"),
                spec((n_swap, heads, bs, hd), "float32"),
                spec((2,), "int32"), spec((2,), "int32"),
                spec((2,), "int32"))


GRAPHS = {"matmul": _matmul_graph, "fused_mlp": _fused_mlp_graph,
          "spmv": _spmv_graph, "paged_swap": _paged_swap_graph}


def _port_emit(graph: str, backend: str) -> str:
    fn, specs = GRAPHS[graph](tops, TensorSpec)
    return tpipe.compile(fn, *specs, options=TOptions(
        target=backend, device="cpu"), name=graph).emit_cpp_source()


def _ref_emit(graph: str, backend: str) -> str:
    fn, specs = GRAPHS[graph](jops, _jspec)
    return jpipe.compile(fn, *specs, options=JOptions(target=backend),
                         name=graph).emit_cpp_source()


def _reference_of(graph: str, backend: str) -> str:
    """The reference backend whose unit has the port backend's layout."""
    if backend == "cuda":
        return "xla" if graph == "spmv" else "pallas"
    return "xla"


_UNITS: dict = {}


def _unit(package: str, graph: str, backend: str) -> str:
    key = (package, graph, backend)
    if key not in _UNITS:
        emit = _port_emit if package == "port" else _ref_emit
        _UNITS[key] = emit(graph, backend)
    return _UNITS[key]


def _port(graph, backend):
    return _unit("port", graph, backend)


def _code_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith("//")]


# ---------------------------------------------------------------------------
# the units against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", HOST)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_host_units_equal_the_reference_goldens(graph, backend):
    golden = (GOLDEN_DIR / f"{graph}_{backend}.cpp").read_text()
    assert _port(graph, backend) == golden


@pytest.mark.parametrize("backend", DEVICE)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_device_units_are_deterministic_and_the_references_code(graph,
                                                                backend):
    text = _port(graph, backend)
    assert _port_emit(graph, backend) == text          # byte-deterministic
    ref = _unit("ref", graph, _reference_of(graph, backend))
    assert _code_lines(text) == _code_lines(ref)
    assert f"backend: {backend} " in text


@pytest.mark.skipif(GXX is None, reason="no C++ compiler present")
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_units_syntax_check_against_the_stub(graph, backend, tmp_path):
    path = tmp_path / f"{graph}_{backend}.cpp"
    path.write_text(_port(graph, backend))
    proc = subprocess.run(
        [GXX, "-std=c++17", "-fsyntax-only", f"-I{STUB_DIR}", str(path)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# structure: the paper's constructs appear where the IR says they should
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_mlp_has_acceptance_constructs(backend):
    text = _port("fused_mlp", backend)
    assert "Kokkos::parallel_for" in text
    assert "Kokkos::TeamPolicy" in text          # gemm/softmax nests
    assert ".sync_device();" in text             # DualView lazy h2d
    assert "kokkos.fused replay" in text         # one-lambda region body
    assert "lapis_initialize" in text            # §4.4 weight loading
    assert "#include <Kokkos_Core.hpp>" in text
    assert "import " not in text                 # no Python leaked through


@pytest.mark.parametrize("backend", BACKENDS)
def test_spmv_storage_format_per_backend(backend):
    text = _port("spmv", backend)
    assert "LapisCsr" in text                    # sparse.pack always CSR
    if backend_mod.get_backend(backend).has_capability("ell-layout"):
        assert "CSR -> padded ELL" in text       # sparse.convert kernel
        assert ".valid(row, kk)" in text         # ELL row loop
    else:
        assert "CSR -> padded ELL" not in text
        assert ".valid(row, kk)" not in text
        assert ".rowptr(row + 1)" in text        # CSR row loop
    # only the host backends convert: the card's kernels read CSR
    assert ("CSR -> padded ELL" in text) == (backend in HOST)


@pytest.mark.parametrize("backend", BACKENDS)
def test_paged_swap_spells_page_copy_directions(backend):
    text = _port("paged_swap", backend)
    assert text.count("kokkos.page_copy") == 3
    for direction in ("swap_out", "swap_in", "copy"):
        assert f"direction={direction}" in text
    assert text.count("// in-place block copy") == 3
    assert "Kokkos::TeamPolicy" in text
    assert "Kokkos::ThreadVectorRange" in text


@pytest.mark.parametrize("backend", BACKENDS)
def test_cabi_harness_structure(backend):
    text = _port("spmv", backend)
    assert 'extern "C" void lapis_run(const float** ins, float** outs)' \
        in text
    for fn in ("lapis_num_inputs", "lapis_num_outputs", "lapis_input_rank",
               "lapis_input_dim", "lapis_input_dtype", "lapis_output_rank",
               "lapis_output_dim", "lapis_output_dtype", "lapis_setup"):
        assert f'extern "C" ' in text and fn in text
    assert "lapis_num_inputs() { return 4; }" in text
    assert "lapis_input_dtype(int i) {\n  static const int t[4] = " \
        "{1, 1, 0, 0};" in text                  # int32 before f32
    assert "lapis_run();" not in text
    assert "static bool lapis_initialized" in text
    assert "lapis_setup();" in text


def test_translate_target_spelling():
    assert "using lapis_exec = Kokkos::Serial;" in _port("matmul", "loops")
    assert "using lapis_exec = Kokkos::OpenMP;" in _port("matmul", "openmp")
    for backend in DEVICE:
        assert "using lapis_exec = Kokkos::DefaultExecutionSpace;" in \
            _port("matmul", backend)
        assert backend_mod.get_backend(backend).translate_target is None


def test_translate_target_hook_overrides_default():
    loops = backend_mod.get_backend("loops")
    assert loops.resolve_translate_target().exec_space == "Kokkos::Serial"
    spelled = dataclasses.replace(
        loops, name="loops-spelled",
        translate_target=backend_mod.TranslateTarget(
            exec_space="Kokkos::Threads"))
    assert spelled.resolve_translate_target().exec_space == \
        "Kokkos::Threads"
    assert backend_mod.get_backend("cuda").resolve_translate_target() == \
        backend_mod.TranslateTarget()


def test_openmp_backend_is_pure_declaration():
    """The openmp unit differs from the loops unit only in the declared
    spellings: the exec-space alias and the hierarchy's level names."""
    def scrub(text):
        return (text.replace("Kokkos::OpenMP", "EXEC")
                    .replace("Kokkos::Serial", "EXEC")
                    .replace("omp-league", "L0").replace("serial-block", "L1")
                    .replace("omp-thread", "L1").replace("omp-simd", "L2")
                    .replace("jnp-vector", "L2").replace("serial", "L0")
                    .replace("backend: openmp", "backend: B")
                    .replace("backend: loops", "backend: B"))
    assert scrub(_port("matmul", "openmp")) == \
        scrub(_port("matmul", "loops"))


def test_collapsed_vs_mapped_nests():
    # library backends: elementwise nests collapse to one flat MDRange;
    # loop-nest backends: the declared TeamThreadRange/ThreadVectorRange
    for backend in ("torch", "auto"):
        assert "Kokkos::MDRangePolicy" in _port("fused_mlp", backend)
    for backend in ("cuda", "loops", "openmp"):
        text = _port("fused_mlp", backend)
        assert "Kokkos::MDRangePolicy" not in text
        assert "Kokkos::TeamThreadRange" in text
        assert "Kokkos::ThreadVectorRange" in text


@pytest.mark.parametrize("backend", ["torch", "cuda", "loops"])
def test_spmm_and_gemv_emission(backend, tmp_path):
    def spmm(ip, ind, val, b):
        return tops.spmm_csr(ip, ind, val, b, n_rows=8, nnz_mean=1.5,
                             max_nnz_row=2)
    specs = (TensorSpec((9,), "int32"), TensorSpec((12,), "int32"),
             TensorSpec((12,), "float32"), TensorSpec((8, 4), "float32"))
    spmm_src = tpipe.compile(
        spmm, *specs, options=TOptions(target=backend, device="cpu"),
        name="spmm").emit_cpp_source()
    assert "kk.spmv" not in spmm_src and "LapisCsr" in spmm_src
    assert "ThreadVectorRange" in spmm_src       # vector over dense cols

    w = np.random.default_rng(3).standard_normal((16,), dtype=np.float32)
    gemv_src = tpipe.compile(
        lambda x: tops.matmul(x, tops.constant(w)),
        TensorSpec((4, 16), "float32"),
        options=TOptions(target=backend, device="cpu"),
        name="gemv").emit_cpp_source()
    assert "kk.gemv" in gemv_src and "parallel_reduce" in gemv_src

    if GXX is not None:
        for name, text in (("spmm", spmm_src), ("gemv", gemv_src)):
            p = tmp_path / f"{name}_{backend}.cpp"
            p.write_text(text)
            proc = subprocess.run(
                [GXX, "-std=c++17", "-fsyntax-only", f"-I{STUB_DIR}",
                 str(p)], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr


def test_bf16_weights_embed_as_float_values():
    """A bf16 graph computes in float in the unit, as the reference's
    does; its weights embed their exact f32 widening."""
    import torch
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, 8)).astype(np.float32)).bfloat16()
    text = tpipe.compile(
        lambda x: tops.matmul(x, tops.constant(w)),
        TensorSpec((4, 16), "bfloat16"),
        options=TOptions(target="cuda", device="cpu"),
        name="bf16").emit_cpp_source()
    assert "// w0: 16x8 bfloat16 (128 elements)" in text
    assert "static const float lapis_w0_data[128]" in text
    first = repr(float(w.flatten()[0].float())) + "f,"
    assert first in text


# ---------------------------------------------------------------------------
# closure leakage and untranslatable graphs are forced into the open
# ---------------------------------------------------------------------------

def test_python_closure_raises_translate_error():
    x = Value(TensorType((4,), "float32"))
    g = Graph("leak", [x])
    op = g.add(Op("linalg.map", [x], [TensorType((4,), "float32")],
                  attrs={"fn": lambda a: a}))
    g.outputs = [op.results[0]]
    with pytest.raises(translate.TranslateError):
        translate.emit_cpp_source(g, TOptions(target="torch", device="cpu"))


def test_zero_extent_graph_raises_translate_error():
    w = np.zeros((16, 8), dtype=np.float32)
    mod = tpipe.compile(
        lambda x: tops.matmul(x, tops.constant(w)),
        TensorSpec((0, 16), "float32"),
        options=TOptions(target="torch", device="cpu"), name="empty")
    assert tuple(mod(np.zeros((0, 16), np.float32)).shape) == (0, 8)
    with pytest.raises(translate.TranslateError, match="zero-extent"):
        mod.emit_cpp_source()


def test_float64_graph_raises_translate_error():
    x = Value(TensorType((4,), "float64"))
    g = Graph("f64", [x])
    op = g.add(Op("linalg.relu", [x], [TensorType((4,), "float64")]))
    g.outputs = [op.results[0]]
    with pytest.raises(translate.TranslateError, match="float64"):
        translate.emit_cpp_source(g, TOptions(target="torch", device="cpu"))


# ---------------------------------------------------------------------------
# CLI: --emit-cpp, --list-backends, --help
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", HOST)
@pytest.mark.parametrize("demo", ["mlp", "spmv"])
def test_cli_emit_cpp_stdout_is_the_references(demo, backend, capsys):
    assert tpipe.main(["--demo", demo, "--target", backend, "--device",
                       "cpu", "--emit-cpp", "-"]) == 0
    port = capsys.readouterr().out
    assert jpipe.main(["--demo", demo, "--target", backend,
                       "--emit-cpp", "-"]) == 0
    assert port == capsys.readouterr().out


def test_cli_emit_cpp_stdout(capsys):
    assert tpipe.main(["--demo", "mlp", "--target", "cuda", "--device",
                       "cpu", "--emit-cpp", "-"]) == 0
    out = capsys.readouterr().out
    assert "Kokkos::parallel_for" in out
    assert "Kokkos::TeamPolicy" in out
    assert ".sync_device();" in out
    # stdout IS the artifact: the demo run report must not pollute it
    assert "output shape:" not in out
    assert out.rstrip().endswith("}")


def test_cli_emit_cpp_file(tmp_path, capsys):
    dest = tmp_path / "spmv.cpp"
    assert tpipe.main(["--demo", "spmv", "--target", "loops", "--device",
                       "cpu", "--emit-cpp", str(dest)]) == 0
    text = dest.read_text()
    assert "LapisCsr" in text and "Kokkos::Serial" in text
    out = capsys.readouterr().out
    assert "wrote" in out and "output shape: (512,)" in out


def test_cli_list_backends_shows_every_spelling(capsys):
    assert tpipe.main(["--list-backends"]) == 0
    out = capsys.readouterr().out
    for b in BACKENDS:
        assert f"\n{b:8s}  caps=[" in "\n" + out
    assert "hierarchy:" in out and "scratch" in out
    spellings = [ln.split("translate: ")[1] for ln in out.splitlines()
                 if "translate: " in ln]
    assert sorted(spellings) == sorted(
        ["Kokkos::DefaultExecutionSpace"] * 3 + ["Kokkos::Serial",
                                                 "Kokkos::OpenMP"])


def test_cli_help_documents_translation(capsys):
    with pytest.raises(SystemExit):
        tpipe.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--emit", "--emit-cpp", "--run-native", "--autotune",
                 "--autotune-top-k", "--device"):
        assert flag in out
    assert "--demo" in out and "spmv" in out   # epilog documents the demos
    assert "lapis-translate" in out
