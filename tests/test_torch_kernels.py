"""The port's kernel modules, on the CPU (plain versions), held to the
reference's Pallas kernels run in interpret mode on the same seeded
inputs: ``kernels/matmul.py`` (kk.gemm, kk.gemv) and ``kernels/generic.py``
(mapped region nests, row softmax).  1e-5 in f32."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.kernels import generic as jgeneric  # noqa: E402
from repro.kernels.matmul import matmul as jmatmul  # noqa: E402
from repro_torch.convert import numpy_to_torch  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import generic, ops as kops  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402

_TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
        jnp.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 70, 250), (256, 512, 128),
                                   (33, 129, 65), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_matmul_matches_pallas_kernel(rng, m, k, n, dtype):
    a = rng.standard_normal((m, k), dtype=np.float32).astype(dtype)
    b = (rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)) \
        .astype(dtype)
    want = np.asarray(jmatmul(a, b, bm=64, bn=128, bk=64, interpret=True),
                      np.float32)
    before = tmm.matmul.plain_calls
    got = tmm.matmul(numpy_to_torch(np.asarray(a)),
                     numpy_to_torch(np.asarray(b)),
                     tiling={"bm": 64, "bn": 128, "bk": 64})
    assert tmm.matmul.plain_calls == before + 1
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, **_TOL[dtype])


@pytest.mark.parametrize("m,k", [(256, 512), (33, 129), (1, 7)])
def test_gemv_matches_pallas_kernel(rng, m, k):
    a = rng.standard_normal((m, k), dtype=np.float32)
    x = rng.standard_normal((k,), dtype=np.float32) / np.sqrt(k)
    want = np.asarray(jmatmul(a, x[:, None], bm=256, bn=128, bk=512,
                              interpret=True))[:, 0]
    got = kops.gemv_cuda(torch.from_numpy(a), torch.from_numpy(x))
    assert got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _demo_nests():
    """The mlp demo's two mapped nests, as lowered by each package for
    its kernel backend."""
    jfn, jspecs, _ = jpipe._demo_mlp()
    tfn, tspecs, _ = tpipe._demo_mlp()
    jg = jpipe.compile(jfn, *jspecs,
                       options=JOptions(target="pallas", interpret=True)).graph
    tg = tpipe.compile(tfn, *tspecs,
                       options=TOptions(target="cuda", device="cpu")).graph

    def nests(g):
        return [op for op in g.ops if op.opname == "kokkos.team_parallel"]
    return list(zip(nests(jg), nests(tg)))


def test_fused_region_nest_matches_pallas_block_map_region(rng):
    (jop, top), _ = _demo_nests()
    assert top.attrs["ops"] == jop.attrs["ops"] == ("linalg.add",
                                                    "linalg.relu")
    args = [rng.standard_normal(o.type.shape, dtype=np.float32)
            for o in jop.operands]
    want = np.asarray(jgeneric.block_map_region(
        jop.regions[0], args, jop.results[0].type.shape, "float32",
        block=jop.attrs["tiling"]["block"], interpret=True))
    got = generic.block_map_region(
        top.regions[0], [torch.from_numpy(a) for a in args],
        top.results[0].type.shape, "float32",
        block=top.attrs["tiling"]["block"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_softmax_nest_matches_pallas_block_map(rng):
    _, (jop, top) = _demo_nests()
    assert jop.attrs["kind"] == top.attrs["kind"] == "reduce"
    x = rng.standard_normal(jop.operands[0].type.shape, dtype=np.float32) * 4
    want = np.asarray(jgeneric.block_map(
        jop.attrs["fn"], [x], jop.results[0].type.shape, "float32",
        block=jop.attrs["tiling"]["block"], interpret=True))
    got = generic.row_softmax(torch.from_numpy(x),
                              block=top.attrs["tiling"]["block"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unfused_map_nest_matches_reference(rng):
    """An unfused nest's kernel is generated from its src opname as a
    one-op region; the result is the reference op's."""
    spec = ((6, 40), "float32")
    jmod = jpipe.compile(jops.maximum, jax.ShapeDtypeStruct(*spec),
                         jax.ShapeDtypeStruct(*spec),
                         options=JOptions(target="pallas", interpret=True))
    tmod = tpipe.compile(tops.maximum, TensorSpec(*spec), TensorSpec(*spec),
                         options=TOptions(target="cuda", device="cpu"))
    (nest,) = [op for op in tmod.graph.ops
               if op.opname == "kokkos.team_parallel"]
    region = generic.one_op_region(nest)
    assert [s.opname for s in region.ops] == ["linalg.maximum"]
    a = rng.standard_normal(spec[0], dtype=np.float32)
    b = rng.standard_normal(spec[0], dtype=np.float32)
    np.testing.assert_allclose(tmod(a, b).numpy(), np.asarray(jmod(a, b)),
                               rtol=1e-5, atol=1e-5)
    assert tmod.launch_count == jmod.launch_count == 1
