"""The serving slice's kernel modules and attention layers held to the JAX
reference on the CPU.

* **Kernel modules** — the port's RMSNorm, decode attention and flash
  attention, called through the model-facing wrappers for the ``cuda``
  target on CPU tensors (hence their plain versions), against the
  reference's Pallas kernels in interpret mode at the sweep shapes of
  ``tests/test_kernels.py``, to the reference's tolerances (2e-4, 2e-5
  for RMSNorm).
* **Layers** — ``_project_qkv`` with RoPE, the prefill, contiguous
  decode, paged decode (plain and int8) and paged chunked-prefill
  attention on the same converted f32 weights and inputs, to 1e-5, on
  the port's ``cuda`` (plain versions on the CPU) and ``torch`` targets.
* **No quiet fallback** — meta tensors reaching a new wrapper raise.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.core.options import use_options as juse  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jdecode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jflash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402


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


PORT_TARGETS = ["cuda", "torch"]
ON_CPU = TOptions(target="cuda", device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy().astype(np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# kernel modules at the reference's sweep shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 64), (3, 33, 128), (1, 1, 256)])
def test_rmsnorm_sweep_matches_reference_kernel(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jrmsnorm(x, w, block_rows=4, interpret=True)
    before = trn.rmsnorm.plain_calls
    with tuse(ON_CPU):
        got = kops.rmsnorm(_t(x), _t(w))
    assert trn.rmsnorm.plain_calls == before + 1
    _close(got, want, 2e-5)


@pytest.mark.parametrize("hq,hkv,s,window", [
    (4, 4, 100, None), (8, 2, 128, None), (4, 1, 90, 33), (2, 2, 64, 16)])
def test_decode_attention_sweep_matches_reference_kernel(rng, hq, hkv, s,
                                                         window):
    B, D = 3, 32
    q = rng.standard_normal((B, hq, D), dtype=np.float32)
    k = rng.standard_normal((B, hkv, s, D), dtype=np.float32)
    v = rng.standard_normal((B, hkv, s, D), dtype=np.float32)
    lengths = np.asarray(rng.integers(1, s + 1, B), np.int32)
    want = jdecode(q, k, v, jnp.asarray(lengths), window=window, bs=32,
                   interpret=True)
    before = tda.decode_attention.plain_calls
    with tuse(ON_CPU):
        got = kops.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                    window=window)
    assert tda.decode_attention.plain_calls == before + 1
    _close(got, want, 2e-4)


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", [
    (4, 4, 64, 64, True, None), (4, 2, 100, 100, True, None),
    (8, 1, 64, 64, True, 17), (4, 4, 32, 96, False, None),
    (6, 2, 65, 65, True, 33)])
def test_flash_attention_sweep_matches_reference_kernel(rng, hq, hkv, sq,
                                                        skv, causal, window):
    q = rng.standard_normal((2, hq, sq, 32), dtype=np.float32)
    k = rng.standard_normal((2, hkv, skv, 32), dtype=np.float32)
    v = rng.standard_normal((2, hkv, skv, 32), dtype=np.float32)
    want = jflash(q, k, v, causal=causal, window=window, bq=32, bkv=32,
                  interpret=True)
    before = tfa.flash_attention.plain_calls
    with tuse(ON_CPU):
        got = kops.attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    assert tfa.flash_attention.plain_calls == before + 1
    _close(got, want, 2e-4)


def test_flash_attention_softcap_matches_reference_kernel(rng):
    q = rng.standard_normal((1, 2, 48, 16), dtype=np.float32)
    k = rng.standard_normal((1, 2, 48, 16), dtype=np.float32)
    v = rng.standard_normal((1, 2, 48, 16), dtype=np.float32)
    want = jflash(q, k, v, causal=True, logit_softcap=30.0, bq=16, bkv=16,
                  interpret=True)
    with tuse(ON_CPU):
        got = kops.attention(_t(q), _t(k), _t(v), causal=True,
                             logit_softcap=30.0)
    _close(got, want, 2e-4)


def test_plain_versions_match_the_reference_oracles_in_bf16(rng):
    """f32 compute, output rounded once to bf16, in both packages."""
    q = rng.standard_normal((2, 4, 40, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, 40, 32), dtype=np.float32)
    x = rng.standard_normal((6, 64), dtype=np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    want = jref.attention(jb(q), jb(k), jb(k), window=9)
    got = kops.attention(tb(q), tb(k), tb(k), window=9, options=ON_CPU)
    _close(got.float(), np.asarray(want, np.float32), 1e-2)
    want = jref.rmsnorm(jb(x), jb(w))
    got = kops.rmsnorm(tb(x), tb(w), options=ON_CPU)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 1e-2)


def test_kernel_backward_is_the_plain_versions(rng):
    """``_Kernelized``: the forward is the wrapper's, the gradient the
    plain version's (here both are plain, on the CPU)."""
    q = _t(rng.standard_normal((1, 2, 9, 16), dtype=np.float32))
    q.requires_grad_(True)
    k = _t(rng.standard_normal((1, 1, 9, 16), dtype=np.float32))
    out = kops.attention(q, k, k, options=ON_CPU)
    (g,) = torch.autograd.grad(out.square().sum(), [q])
    q2 = q.detach().requires_grad_(True)
    (g2,) = torch.autograd.grad(
        kops.ref.attention(q2, k, k).square().sum(), [q2])
    torch.testing.assert_close(g, g2)


@pytest.mark.parametrize("call", ["rmsnorm", "decode_attention",
                                  "flash_attention"])
def test_meta_tensors_raise_instead_of_falling_back(call):
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="meta"):
        if call == "rmsnorm":
            trn.rmsnorm(m(4, 8), m(8))
        elif call == "decode_attention":
            tda.decode_attention(m(2, 4, 16), m(2, 2, 8, 16), m(2, 2, 8, 16),
                                 m(2, dtype=torch.int32))
        else:
            tfa.flash_attention(m(1, 2, 8, 16), m(1, 2, 8, 16),
                                m(1, 2, 8, 16))


def test_kk_attention_is_registered_for_both_targets(rng):
    from repro_torch.core.registry import dispatch
    q = _t(rng.standard_normal((1, 2, 7, 16), dtype=np.float32))
    want = kops.ref.attention(q, q, q)
    for target in ("torch", "cuda"):
        got = dispatch("kk.attention", ON_CPU, target=target)(q, q, q)
        torch.testing.assert_close(got, want)


# ---------------------------------------------------------------------------
# attention layers on converted weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    """Layer 0's attention weights of the reduced qwen2-1.5b at f32
    compute, in both packages (the reference's init, converted)."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b", reduced=True),
                               compute_dtype="float32")
    jparams = jsteps.cast_compute(jbuild(jcfg).init(0), "float32")
    rng = np.random.default_rng(7)
    # the init leaves the qkv biases at zero: give them values
    attn = dict(jparams["layers"]["attn"])
    for key in ("bq", "bk", "bv"):
        attn[key] = jnp.asarray(
            rng.standard_normal(attn[key].shape).astype(np.float32) * 0.1)
    jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    tparams = model_params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    tp = layer_params(tparams, 0)["attn"]
    return jcfg, tcfg, jp, tp


def _opts(target):
    return TOptions(target=target, device="cpu")


@pytest.mark.parametrize("target", PORT_TARGETS)
def test_project_qkv_with_rope_matches_reference(layer, rng, target):
    jcfg, tcfg, jp, tp = layer
    x = rng.standard_normal((2, 7, jcfg.d_model), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(3, 10)]).astype(np.int32)
    want = jattn._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    with tuse(_opts(target)):
        got = tattn._project_qkv(tp, _t(x), tcfg, _t(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("target", PORT_TARGETS)
def test_attention_prefill_matches_reference(layer, rng, target, quantized):
    jcfg, tcfg, jp, tp = layer
    x = rng.standard_normal((2, 9, jcfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    with juse(JOptions(target="xla")):
        want, wcache = jattn.apply_attention_prefill(
            jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
            quantized=quantized)
    with tuse(_opts(target)):
        got, gcache = tattn.apply_attention_prefill(
            tp, _t(x), tcfg, positions=_t(pos), quantized=quantized)
    _close(got, want, 1e-5)
    assert sorted(gcache) == sorted(wcache)
    for key in wcache:
        _close(gcache[key], wcache[key], 1e-5)


@pytest.mark.parametrize("target", PORT_TARGETS)
def test_attention_decode_matches_reference(layer, rng, target):
    jcfg, tcfg, jp, tp = layer
    B, S, length = 3, 12, 7
    x = rng.standard_normal((B, jcfg.d_model), dtype=np.float32)
    shape = (B, jcfg.n_kv_heads, S, jcfg.head_dim)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    with juse(JOptions(target="xla")):
        want, wcache = jattn.apply_attention_decode(
            jp, jnp.asarray(x), jcfg,
            cache={k: jnp.asarray(v) for k, v in cache.items()},
            length=jnp.int32(length))
    with tuse(_opts(target)):
        got, gcache = tattn.apply_attention_decode(
            tp, _t(x), tcfg, cache={k: _t(v) for k, v in cache.items()},
            length=length)
    _close(got, want, 1e-5)
    for key in wcache:
        _close(gcache[key], wcache[key], 1e-5)


def _paged_pools(rng, cfg, n_blocks, bs, quantized):
    shape = (n_blocks, cfg.n_kv_heads, bs, cfg.head_dim)
    if quantized:
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(1e-3, 2e-2, shape[:3] + (1,))
                .astype(np.float32),
                "v_scale": rng.uniform(1e-3, 2e-2, shape[:3] + (1,))
                .astype(np.float32)}
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("target", PORT_TARGETS)
def test_attention_decode_paged_matches_reference(layer, rng, target,
                                                  quantized):
    jcfg, tcfg, jp, tp = layer
    B, bs, mb, nb = 4, 4, 3, 14
    x = rng.standard_normal((B, jcfg.d_model), dtype=np.float32)
    pools = _paged_pools(rng, jcfg, nb, bs, quantized)
    table = (rng.permutation(np.arange(1, nb))[:B * mb]
             .reshape(B, mb).astype(np.int32))
    lengths = np.asarray([0, 5, 11, 7], np.int32)
    with juse(JOptions(target="xla")):
        want, wpools = jattn.apply_attention_decode_paged(
            jp, jnp.asarray(x), jcfg,
            pools={k: jnp.asarray(v) for k, v in pools.items()},
            table=jnp.asarray(table), lengths=jnp.asarray(lengths),
            block_size=bs)
    with tuse(_opts(target)):
        got, gpools = tattn.apply_attention_decode_paged(
            tp, _t(x), tcfg, pools={k: _t(v) for k, v in pools.items()},
            table=_t(table), lengths=_t(lengths), block_size=bs)
    _close(got, want, 1e-5)
    for key in wpools:
        _close(gpools[key], wpools[key], 1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("target", PORT_TARGETS)
def test_attention_prefill_chunk_paged_matches_reference(layer, rng, target,
                                                         quantized):
    jcfg, tcfg, jp, tp = layer
    bs, C, start, nb = 4, 6, 8, 12
    x = rng.standard_normal((C, jcfg.d_model), dtype=np.float32)
    pools = _paged_pools(rng, jcfg, nb, bs, quantized)
    row = np.asarray([3, 7, 1, 9, 4, 0], np.int32)
    with juse(JOptions(target="xla")):
        want, wpools = jattn.apply_attention_prefill_chunk_paged(
            jp, jnp.asarray(x), jcfg,
            pools={k: jnp.asarray(v) for k, v in pools.items()},
            table_row=jnp.asarray(row), start=jnp.int32(start),
            block_size=bs)
    with tuse(_opts(target)):
        got, gpools = tattn.apply_attention_prefill_chunk_paged(
            tp, _t(x), tcfg, pools={k: _t(v) for k, v in pools.items()},
            table_row=_t(row), start=start, block_size=bs)
    _close(got, want, 1e-5)
    for key in wpools:
        _close(gpools[key], wpools[key], 1e-5)


@pytest.mark.parametrize("rows,positions", [
    (16, 544), (16, 2048), (256, 544), (24, 100), (1, 1), (16, 0),
    (3, 90), (128, 2048), (300, 7)])
def test_decode_attention_split_plan_covers_every_position(rows, positions):
    """The card kernel splits each row's positions into chunks: together
    they cover the cache, each a whole number of the ring's 64-position
    tiles, and never more blocks than needed to reach about two per SM."""
    n, chunk = tda.split_plan(rows, positions)
    assert n >= 1 and chunk % tda.TILE == 0 and n * chunk >= positions
    assert (n - 1) * chunk < max(positions, 1)
    if n > 1:
        assert chunk >= tda.MIN_CHUNK and rows * (n - 1) < tda.SPLIT_BLOCKS


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_decode_attention_launch_plan_fits_the_card(d):
    """Every query head of a KV head in one block up to rep 64 in bf16
    (K and V read once), m16 tiles covering the heads, O at 128 f32
    registers a thread at most (64 above one m16 tile), and the ring (or the merge it turns into), Q and
    the scores inside the 232,448 bytes of shared memory a block may use,
    with at least one stage and no more stages than the chunk has
    tiles."""
    for rep in (1, 2, 6, 8, 9, 16, 32):
        for chunk in (64, 128, 2048):
            tiles = -(-chunk // tda.TILE)
            for dtype in (torch.bfloat16, torch.float32):
                p = tda.launch_plan(d, rep, chunk, dtype)
                assert p["smem_bytes"] <= tda.SMEM_LIMIT
                assert 1 <= p["stages"] <= min(tda.MAX_STAGES, tiles)
                assert p["groups"] * p["heads"] >= rep
                assert (p["groups"] - 1) * p["heads"] < rep
                assert p["padded_dim"] >= d
                if dtype == torch.bfloat16:
                    assert p["groups"] == 1 and p["heads"] == rep
                    assert 16 * p["mt"] >= p["heads"]
                    units = -(-p["padded_dim"] // 16)
                    per_warp = -(-units // p["wd"])
                    assert p["wd"] in (1, 2, 4)
                    assert p["mt"] * per_warp * 2 * 4 <= \
                        (128 if p["mt"] == 1 else 64)
                else:
                    assert p["heads"] * p["padded_dim"] <= 4096


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_sm90_launch_plan_fits_the_card(d):
    """The bf16 kernel's tiles for every head dim: 128 query rows, KV tiles
    of 128 in three stages up to D = 128 and of 64 in two above, D padded
    to whole 64-column swizzle atoms, and the dynamic shared memory inside
    the 232,448 bytes a block may use; O (D / 2 f32 registers a consumer
    thread at the padded width) stays at 128 or fewer."""
    plan = tfa.sm90_plan(d)
    dp = plan["padded_dim"]
    assert dp % 64 == 0 and d <= dp < d + 64
    assert plan["block_q"] == 128
    assert (plan["block_kv"], plan["stages"]) == \
        ((128, 3) if dp <= 128 else (64, 2))
    q_bytes = plan["block_q"] * dp * 2
    ring = plan["stages"] * 2 * plan["block_kv"] * dp * 2
    assert plan["smem_bytes"] == 1024 + q_bytes + ring + 8 * (
        1 + 3 * plan["stages"])
    assert plan["smem_bytes"] <= tfa.SMEM_LIMIT
    assert dp // 2 <= 128


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_eligibility_of_views():
    """TMA reads an operand in place when D is contiguous, the base is
    16-byte aligned and every other stride of an extent above 1 is a
    positive multiple of 16 bytes; anything else is made contiguous by
    the wrapper before the kernel reads it."""
    assert tfa.tma_ready(_bf16(2, 4, 100, 128))
    # the model's (B, S, H, D) projections transposed to (B, H, S, D)
    assert tfa.tma_ready(_bf16(2, 100, 12, 128).transpose(1, 2))
    assert tfa.tma_ready(_bf16(1, 2040, 1, 256).transpose(1, 2))
    assert tfa.tma_ready(_bf16(2, 4, 100, 16))
    # a base 2 bytes past alignment
    n = 2 * 4 * 100 * 128
    flat = _bf16(8 + n)
    assert flat.data_ptr() % 16 == 0
    assert not tfa.tma_ready(flat[1:1 + n].view(2, 4, 100, 128))
    assert tfa.tma_ready(flat[8:8 + n].view(2, 4, 100, 128))
    # a position stride of 72 bytes (a 32-column slice of 36)
    assert not tfa.tma_ready(_bf16(1, 2, 8, 36)[..., :32])
    assert tfa.tma_ready(_bf16(1, 2, 8, 72)[..., :32])
    # D not contiguous, or a head axis broadcast with stride 0
    assert not tfa.tma_ready(_bf16(1, 2, 64, 32).transpose(2, 3))
    assert not tfa.tma_ready(_bf16(1, 1, 64, 32).expand(1, 4, 64, 32))
    # an extent of 1 leaves its stride free
    one = _bf16(1, 4, 1, 64)
    assert tfa.tma_ready(one.as_strided(one.shape, (999, 64, 3, 1)))
