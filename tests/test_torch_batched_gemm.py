"""The port's batched product on the CPU (plain versions), held to the
reference: ``kernels/batched_gemm.py`` (both kernels' wrappers, the
tilings and build records the H100 pass gives them, the operand views
the kernels read) and ``kk.batched_gemm`` through ``pipeline.compile``
on every port target, against the reference's Pallas kernel in
interpret mode and its ``xla`` / ``loops`` / ``pallas`` targets.  2e-4
in f32, as the reference's ``test_batched_gemm_sweep``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.kernels.batched_gemm import batched_gemm as jbgemm  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options  # noqa: E402
from repro_torch.core.tracer import TensorSpec  # noqa: E402
from repro_torch.kernels import batched_gemm as bg  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

_TOL = dict(rtol=2e-4, atol=2e-4)
_SWEEP = [(12, 16, 24, 32, True), (3, 130, 70, 150, False), (1, 8, 8, 8, True),
          (7, 64, 64, 64, None)]
# (A shape, B shape): broadcast B as 2-D and as a size-1 batch, a 4-D batch
_BROADCAST = [((5, 16, 24), (24, 32)), ((5, 40, 24), (1, 24, 48)),
              ((2, 3, 20, 30), (2, 3, 30, 40)), ((4, 70, 33), (33, 90))]
# the Fig 6.3 cases and the card-scale ones: (A, B) -> (kernel, bm, bn, bk,
# batch_block) the pass chooses on the H100 hierarchy in f32
_H100_TILINGS = {
    ((256, 16, 16), (256, 16, 16)): (True, 16, 32, 32, 32),
    ((256, 32, 32), (256, 32, 32)): (True, 32, 32, 32, 32),
    ((64, 64, 64), (64, 64, 64)): (False, 64, 64, 64, 1),
    ((16, 128, 128), (16, 128, 128)): (False, 64, 128, 64, 1),
    ((16384, 32, 32), (16384, 32, 32)): (True, 32, 32, 32, 32),
    ((12, 2048, 128), (12, 128, 2048)): (False, 64, 128, 64, 1),
    ((8, 256, 1536), (1536, 8960)): (False, 64, 128, 64, 1),
}


def _pair(rng, sa, sb):
    return (rng.standard_normal(sa, dtype=np.float32),
            rng.standard_normal(sb, dtype=np.float32))


def _reset_counts():
    for w in (bg.batched_gemm_small, bg.batched_gemm_tiled):
        w.launches = w.plain_calls = 0


@pytest.mark.parametrize("b,m,k,n,vec", _SWEEP)
def test_batched_gemm_matches_pallas_kernel(rng, b, m, k, n, vec):
    a, bb = _pair(rng, (b, m, k), (b, k, n))
    want = np.asarray(jbgemm(a, bb, vectorize_batch=vec, bm=32, bn=64, bk=32,
                             interpret=True))
    tiling = {"bm": 32, "bn": 64, "bk": 32, "batch_block": 8,
              "vectorize_batch": vec}
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    np.testing.assert_allclose(ref.batched_gemm(ta, tb).numpy(), want, **_TOL)
    _reset_counts()
    got = kops.batched_gemm_cuda(ta, tb, tiling=tiling)
    small = vec if vec is not None else m * n <= 1024
    assert (bg.batched_gemm_small.plain_calls,
            bg.batched_gemm_tiled.plain_calls) == (int(small),
                                                   int(not small))
    np.testing.assert_allclose(got.numpy(), want, **_TOL)


@pytest.mark.parametrize("sa,sb", _BROADCAST)
def test_broadcast_and_4d_batches_match_pallas_kernel(rng, sa, sb):
    a, b = _pair(rng, sa, sb)
    want = np.asarray(jbgemm(a, b, bm=32, bn=64, bk=32, interpret=True))
    got = bg.batched_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_TOL)


def test_plain_version_accumulates_in_f32_and_keeps_a_dtype(rng):
    a, b = _pair(rng, (4, 8, 300), (300, 16))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    got = ref.batched_gemm(ta, tb)
    assert got.dtype == torch.bfloat16
    want = torch.matmul(ta.float(), tb.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def _batched_fn(a, b):
    return tops.matmul(a, b)


def _jbatched_fn(a, b):
    return jops.matmul(a, b)


@pytest.mark.parametrize("sa,sb", [((12, 16, 24), (12, 24, 32)),
                                   ((3, 130, 70), (3, 70, 150)),
                                   ((5, 16, 24), (24, 32))])
def test_compiled_batched_matmul_matches_reference_targets(rng, sa, sb):
    a, b = _pair(rng, sa, sb)
    want = {t: np.asarray(jpipe.compile(
        _jbatched_fn, jax.ShapeDtypeStruct(sa, "float32"),
        jax.ShapeDtypeStruct(sb, "float32"),
        options=JOptions(target=t, interpret=True))(a, b))
        for t in ("xla", "loops", "pallas")}
    for target in ("torch", "cuda", "loops", "auto"):
        _reset_counts()
        mod = tpipe.compile(_batched_fn, TensorSpec(sa, "float32"),
                            TensorSpec(sb, "float32"),
                            options=TOptions(target=target, device="cpu"))
        (op,) = [o for o in mod.graph.ops if o.opname.startswith("kk.")]
        assert op.opname == "kk.batched_gemm"
        got = mod(a, b).numpy()
        for t, w in want.items():
            np.testing.assert_allclose(got, w, err_msg=f"{target} vs {t}",
                                       **_TOL)
        plain = (bg.batched_gemm_small.plain_calls
                 + bg.batched_gemm_tiled.plain_calls)
        assert plain == (1 if target == "cuda" else 0)


def test_eager_batched_matmul_dispatches_to_the_wrapper(rng):
    a, b = _pair(rng, (6, 8, 16), (6, 16, 8))
    _reset_counts()
    with use_options(TOptions(target="cuda", device="cpu")):
        got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert bg.batched_gemm_small.plain_calls == 1
    np.testing.assert_allclose(got.numpy(), a @ b, **_TOL)


def _pass_tiling(sa, sb, dtype="float32"):
    mod = tpipe.compile(_batched_fn, TensorSpec(sa, dtype),
                        TensorSpec(sb, dtype),
                        options=TOptions(target="cuda", device="cpu"))
    (op,) = [o for o in mod.graph.ops if o.opname == "kk.batched_gemm"]
    return mod, op.attrs["tiling"]


@pytest.mark.parametrize("shapes", list(_H100_TILINGS))
def test_h100_tilings_are_pinned(shapes):
    _, t = _pass_tiling(*shapes)
    small, bm, bn, bk, bb = _H100_TILINGS[shapes]
    assert t["vectorize_batch"] is small
    assert (t["bm"], t["bn"], t["bk"], t["batch_block"]) == (bm, bn, bk, bb)
    m, n = shapes[0][-2], shapes[1][-1]
    assert bg.check_tiling(t, m, n) == ((True, 0, 0, bk, bb) if small
                                        else (False, bm, bn, bk, 1))


@pytest.mark.parametrize("dtype,itemsize", [("float32", 4), ("bfloat16", 2)])
@pytest.mark.parametrize("shapes", list(_H100_TILINGS)
                         + [((2, 3, 20, 30), (2, 3, 30, 40))])
def test_default_tiling_is_the_pass_choice(shapes, dtype, itemsize):
    _, t = _pass_tiling(*shapes, dtype=dtype)
    assert bg.default_tiling(*shapes, itemsize) == t


def test_kernel_sources_name_the_batched_library_at_its_tiling():
    """The small library is built per K chunk; the tiled one once, with
    every tile of its launch plan compiled in (no defines)."""
    for shapes, (small, bm, bn, bk, _) in _H100_TILINGS.items():
        mod, _ = _pass_tiling(*shapes)
        (ks,) = kops.kernel_sources(mod.graph)
        assert ks.name == "batched_gemm"
        assert "lapis_bgemm_small" in ks.source
        assert ks.defines == ((("LAPIS_SMALL", 1), ("LAPIS_BK", bk)) if small
                              else ())


def test_check_tiling_refuses_what_the_kernels_cannot_run():
    with pytest.raises(ValueError, match="small batched kernel"):
        bg.check_tiling({"bm": 64, "bn": 64, "bk": 32, "batch_block": 8,
                         "vectorize_batch": True}, 64, 64)
    with pytest.raises(ValueError, match="small batched kernel"):
        bg.check_tiling({"bm": 8, "bn": 8, "bk": 0, "batch_block": 8,
                         "vectorize_batch": True}, 16, 16)
    # the small kernel's K chunk halves until one matrix's chunks fit
    # 227 KiB: 1 x 1000 outputs at bk 64 would stage 256,260 B
    assert bg.check_tiling({"bm": 8, "bn": 128, "bk": 64, "batch_block": 5,
                            "vectorize_batch": True}, 1, 1000) == \
        (True, 0, 0, 32, 5)
    with pytest.raises(ValueError, match="cannot run tiling"):
        bg.check_tiling({"bm": 12, "bn": 64, "bk": 32,
                         "vectorize_batch": False}, 130, 150)
    # no vectorize_batch: the H100 rule, m·n <= 1024
    assert bg.check_tiling({"bm": 32, "bn": 32, "bk": 32}, 32, 32)[0]
    assert not bg.check_tiling({"bm": 32, "bn": 32, "bk": 32}, 32, 33)[0]


def _check_small_plan(m, n, k, batch, batch_block, itemsize, bk):
    p = bg.small_plan(m, n, k, batch, batch_block, itemsize, bk)
    # at most batch_block matrices a block, and enough blocks to give
    # every SM two whenever the batch has them
    assert 1 <= p["per_block"] <= batch_block
    assert p["grid"] == -(-batch // p["per_block"])
    assert p["grid"] >= min(batch, bg.SMALL_TARGET_BLOCKS)
    # tm x 4 micro-tiles cover the m x n outputs exactly: whole tiles,
    # less than one tile of padding a side
    tm, cols = p["tm"], bg.SMALL_TN
    rows_t, cols_t = -(-m // tm), -(-n // cols)
    assert p["tpm"] == rows_t * cols_t
    assert rows_t * tm - m < tm and cols_t * cols - n < cols
    assert p["threads"] == p["teams"] * p["tpm"] <= (256 if tm >= 4 else 512)
    assert 1 <= p["teams"] <= p["per_block"]
    # the K chunk keeps chunk starts 16-byte aligned; the ring fits
    assert p["bk"] % 8 == 0 and p["bk"] >= 8
    assert p["smem_bytes"] <= bg._mm.MAX_SMEM_BYTES
    rounds = -(-p["per_block"] // p["teams"])
    assert p["stages"] == (2 if rounds * max(1, -(-k // p["bk"])) > 1 else 1)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shapes", [s for s, t in _H100_TILINGS.items()
                                    if t[0]])
def test_small_plan_fills_the_card_at_the_pinned_tilings(shapes, itemsize):
    _, t = _pass_tiling(*shapes, dtype="float32" if itemsize == 4
                        else "bfloat16")
    (batch, m, k), n = shapes[0], shapes[1][-1]
    _check_small_plan(m, n, k, batch, t["batch_block"], itemsize, t["bk"])
    if batch == 16384:   # every SM gets several blocks
        assert bg.small_plan(m, n, k, batch, t["batch_block"], itemsize,
                             t["bk"])["grid"] >= 3 * 132
    elif batch == 256:   # Fig 6.3: one matrix a block, not 8 blocks
        assert bg.small_plan(m, n, k, batch, t["batch_block"], itemsize,
                             t["bk"])["grid"] == 256


@pytest.mark.parametrize("k", [1, 5, 16, 40, 70])
def test_small_plan_sweep(k):
    """m, n in 1..32, a batch tail over and under two blocks per SM; and
    the thin shapes up to 2048 outputs."""
    for m in range(1, 33):
        for n in range(1, 33):
            for batch, bb in ((1, 1), (7, 32), (257, 32), (16384, 32)):
                for itemsize in (4, 2):
                    _check_small_plan(m, n, k, batch, bb, itemsize, 32)
    for m, n in ((1, 2048), (2, 1024), (2048, 1), (1025, 1), (1024, 2),
                 (3, 682), (45, 45)):
        _check_small_plan(m, n, k, 300, 32, 4, 32)


def test_broadcast_operand_is_read_through_stride_zero():
    b = torch.randn(24, 32)
    b3, sb = bg._batched(b, (8,), 24, 32)
    assert sb == 0 and b3.data_ptr() == b.data_ptr()
    b = torch.randn(1, 24, 32)
    b3, sb = bg._batched(b, (2, 3), 24, 32)
    assert sb == 0 and b3.data_ptr() == b.data_ptr()
    # a strided batch is a view too: no copy
    a = torch.randn(6, 16, 24)[::2]
    a3, sa = bg._batched(a, (3,), 16, 24)
    assert sa == 2 * 16 * 24 and a3.data_ptr() == a.data_ptr()
    # batch dims that do not collapse, or transposed matrices, are copied
    b = torch.randn(3, 24, 32)
    b3, sb = bg._batched(b, (2, 3), 24, 32)
    assert sb == 24 * 32 and b3.shape == (6, 24, 32)
    assert torch.equal(b3[4], b[1])
    t = torch.randn(5, 32, 24).transpose(1, 2)
    t3, st = bg._batched(t, (5,), 24, 32)
    assert t3.is_contiguous() and st == 24 * 32 and torch.equal(t3, t)


def test_gradient_flows_through_the_kernelized_product(rng):
    a, b = _pair(rng, (4, 16, 24), (24, 8))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((4, 16, 8), dtype=np.float32))
    out = kops.batched_gemm_cuda(ta, tb, tiling=bg.default_tiling(
        ta.shape, tb.shape, 4))
    (out * g).sum().backward()
    ra = torch.from_numpy(a).requires_grad_(True)
    rb = torch.from_numpy(b).requires_grad_(True)
    (torch.matmul(ra, rb) * g).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), ra.grad.numpy(), **_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), rb.grad.numpy(), **_TOL)
