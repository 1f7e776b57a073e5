"""The recurrent modules of the port, held to the JAX reference on the CPU.

The plain RWKV6 and RG-LRU scans (``repro_torch.kernels.ref``, which the
CPU path of each kernel wrapper runs) against the reference's plain scans
and its Pallas kernels in interpret mode, at ``tests/test_kernels.py``'s
sweep shapes, with and without an initial state; then the RWKV6 time and
channel mixes and the Griffin recurrent block, prefill with their state
and one decode step from it, against the reference at f32.  Inputs and
weights come from a numpy seed and reach both packages as numpy arrays.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.core.options import use_options as juse  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru import rglru_scan as jrglru_pallas  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_scan as jrwkv6_pallas  # noqa: E402
from repro.models import rglru_block as jrg  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.core.registry import dispatch  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru as trg_kernel  # noqa: E402
from repro_torch.kernels import rwkv6 as trw_kernel  # noqa: E402
from repro_torch.models import rglru_block as trg  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402


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


TOL = dict(rtol=1e-5, atol=1e-5)        # f32 plain against plain
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's kernel bar
TARGETS = ("cuda", "torch")             # the port's, on CPU tensors


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rwkv_inputs(rng, t, B=2, H=3, K=8, V=16):
    """test_rwkv6_sweep's inputs, plus an initial state."""
    r = rng.standard_normal((B, t, H, K), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, t, H, K), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, t, H, V), dtype=np.float32) * 0.5
    w = 0.5 + 0.4 * rng.random((B, t, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K), dtype=np.float32) * 0.1
    s0 = rng.standard_normal((B, H, K, V), dtype=np.float32) * 0.5
    return r, k, v, w, u, s0


def _rglru_inputs(rng, t, d, B=2):
    """test_rglru_sweep's inputs, plus an initial h."""
    x, r, i = (rng.standard_normal((B, t, d), dtype=np.float32)
               for _ in range(3))
    la = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((B, d), dtype=np.float32)
    return x, r, i, la, h0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,chunk", [(16, 16), (37, 16), (64, 32)])
def test_rwkv6_scan_matches_reference_and_pallas(rng, t, chunk, with_state):
    r, k, v, w, u, s0 = _rwkv_inputs(rng, t)
    state = s0 if with_state else None
    before = (trw_kernel.rwkv6_scan.launches,
              trw_kernel.rwkv6_scan.plain_calls)
    y, s = trw_kernel.rwkv6_scan(*map(_t, (r, k, v, w, u)),
                                 None if state is None else _t(state))
    assert (trw_kernel.rwkv6_scan.launches,
            trw_kernel.rwkv6_scan.plain_calls) == (before[0], before[1] + 1)
    want_y, want_s = jref.rwkv6_scan(r, k, v, w, u, state)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    if not with_state:   # the Pallas kernel starts from zero, returns y
        pallas = jrwkv6_pallas(r, k, v, w, u, chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,d,chunk,dblock", [(16, 32, 8, 32),
                                              (29, 48, 8, 16),
                                              (64, 128, 32, 64)])
def test_rglru_scan_matches_reference_and_pallas(rng, t, d, chunk, dblock,
                                                 with_state):
    x, r, i, la, h0 = _rglru_inputs(rng, t, d)
    state = h0 if with_state else None
    before = (trg_kernel.rglru_scan.launches,
              trg_kernel.rglru_scan.plain_calls)
    y, h = trg_kernel.rglru_scan(*map(_t, (x, r, i, la)),
                                 None if state is None else _t(state))
    assert (trg_kernel.rglru_scan.launches,
            trg_kernel.rglru_scan.plain_calls) == (before[0], before[1] + 1)
    want_y, want_h = jref.rglru_scan(x, r, i, la, state)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    if not with_state:
        pallas = jrglru_pallas(x, r, i, la, chunk=chunk, d_block=dblock,
                               interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas),
                                   **KERNEL_TOL)


def test_scans_keep_the_input_dtype_and_an_f32_state(rng):
    r, k, v, w, u, _ = _rwkv_inputs(rng, 5)
    y, s = tref.rwkv6_scan(*(_t(a).bfloat16() for a in (r, k, v, w, u)))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    x, rg, ig, la, _ = _rglru_inputs(rng, 5, 16)
    y, h = tref.rglru_scan(*(_t(a).bfloat16() for a in (x, rg, ig, la)))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y, s = tref.rwkv6_scan(*(_t(a)[:, :0] for a in (r, k, v, w)), _t(u))
    assert tuple(y.shape) == (2, 0, 3, 16) and not s.any()


def test_a_state_carried_across_calls_equals_one_scan(rng):
    """The final state of a prefix, fed back, continues the scan exactly:
    what prefill hands decode."""
    r, k, v, w, u, _ = _rwkv_inputs(rng, 20)
    whole, s_whole = tref.rwkv6_scan(*map(_t, (r, k, v, w, u)))
    y1, s1 = tref.rwkv6_scan(*(_t(a[:, :13]) for a in (r, k, v, w)), _t(u))
    y2, s2 = tref.rwkv6_scan(*(_t(a[:, 13:]) for a in (r, k, v, w)), _t(u),
                             s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), whole)
    torch.testing.assert_close(s2, s_whole)
    x, rg, ig, la, _ = _rglru_inputs(rng, 20, 24)
    whole, h_whole = tref.rglru_scan(*map(_t, (x, rg, ig, la)))
    y1, h1 = tref.rglru_scan(*(_t(a[:, :7]) for a in (x, rg, ig)), _t(la))
    y2, h2 = tref.rglru_scan(*(_t(a[:, 7:]) for a in (x, rg, ig)), _t(la),
                             h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), whole)
    torch.testing.assert_close(h2, h_whole)


@pytest.mark.parametrize("target", TARGETS)
def test_model_facing_scans_and_registry(rng, target):
    r, k, v, w, u, s0 = _rwkv_inputs(rng, 9)
    x, rg, ig, la, h0 = _rglru_inputs(rng, 9, 16)
    opts = TOptions(target=target, device="cpu")
    y, s = tkops.rwkv6(*map(_t, (r, k, v, w, u)), state=_t(s0),
                       options=opts)
    want_y, want_s = jref.rwkv6_scan(r, k, v, w, u, s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    y, h = tkops.rglru(*map(_t, (x, rg, ig, la)), state=_t(h0), options=opts)
    want_y, want_h = jref.rglru_scan(x, rg, ig, la, h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    got = dispatch("kk.rwkv6_scan", opts, target=target)(
        *map(_t, (r, k, v, w, u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.rwkv6_scan(r, k, v, w, u)[0]), **TOL)
    got = dispatch("kk.rglru_scan", opts, target=target)(
        *map(_t, (x, rg, ig, la)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.rglru_scan(x, rg, ig, la)[0]), **TOL)


def test_kernelized_scan_gradients_match_the_plain_version(rng):
    """The kernel wrapper's backward (the plain version's, through
    ``_Kernelized``) handles the (y, state) pair and the absent state."""
    r, k, v, w, u, _ = _rwkv_inputs(rng, 6)

    def grads(fn):
        args = [_t(a).requires_grad_() for a in (r, k, v, w, u)]
        y, s = fn(*args)
        (y.square().sum() + s.sum()).backward()
        return [a.grad for a in args]

    opts = TOptions(target="cuda", device="cpu")
    got = grads(lambda *a: tkops.rwkv6(*a, options=opts))
    want = grads(tref.rwkv6_scan)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e)
    x, rg, ig, la, h0 = _rglru_inputs(rng, 6, 8)
    args = [_t(a).requires_grad_() for a in (x, rg, ig, la, h0)]
    y, h = tkops.rglru(*args[:4], state=args[4], options=opts)
    y.sum().backward()
    assert all(a.grad is not None for a in args)
    assert float(args[4].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the model blocks
# ---------------------------------------------------------------------------

def _block_params(spec_fn, arch, seed):
    """One block's parameters from the reference's init of the reduced
    config, every leaf nudged by seeded noise so the zero-initialized
    low-rank parts take part; as numpy, for both packages."""
    jcfg = jget_config(arch, reduced=True)
    tree = jax.device_get(jinit(spec_fn(jcfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def _f32(arch):
    import dataclasses
    return (dataclasses.replace(jget_config(arch, reduced=True),
                                compute_dtype="float32"),
            dataclasses.replace(tget_config(arch, reduced=True),
                                compute_dtype="float32"))


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
    elif want is None:
        assert got is None
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


REF_TARGETS = ("xla", "pallas")


@pytest.mark.parametrize("ref_target", REF_TARGETS)
@pytest.mark.parametrize("target", TARGETS)
def test_time_mix_prefill_and_decode_match_reference(rng, target,
                                                     ref_target):
    jcfg, tcfg = _f32("rwkv6-3b")
    p = _block_params(jrwkv.time_mix_spec, "rwkv6-3b", 1)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    with juse(JOptions(target=ref_target)):
        want = jrwkv.apply_time_mix(p, x, jcfg, return_state=True)
        sh, wkv = want[1]
        want_dec = jrwkv.apply_time_mix(p, x1, jcfg, shift_state=sh,
                                        wkv_state=wkv)
    tp = from_numpy_tree(p, "cpu")
    with tuse(TOptions(target=target, device="cpu")):
        got = trwkv.apply_time_mix(tp, _t(x), tcfg, return_state=True)
        got_dec = trwkv.apply_time_mix(tp, _t(x1), tcfg,
                                       shift_state=got[1][0],
                                       wkv_state=got[1][1])
        plain_out = trwkv.apply_time_mix(tp, _t(x), tcfg)
    _close(got, want)
    _close(got_dec, want_dec)
    _close(plain_out, want[0])


@pytest.mark.parametrize("target", TARGETS)
def test_channel_mix_prefill_and_decode_match_reference(rng, target):
    jcfg, tcfg = _f32("rwkv6-3b")
    p = _block_params(jrwkv.channel_mix_spec, "rwkv6-3b", 2)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want = jrwkv.apply_channel_mix(p, x, jcfg, return_state=True)
    want_dec = jrwkv.apply_channel_mix(p, x1, jcfg, shift_state=want[1])
    tp = from_numpy_tree(p, "cpu")
    with tuse(TOptions(target=target, device="cpu")):
        got = trwkv.apply_channel_mix(tp, _t(x), tcfg, return_state=True)
        got_dec = trwkv.apply_channel_mix(tp, _t(x1), tcfg,
                                          shift_state=got[1])
    _close(got, want)
    _close(got_dec, want_dec)


@pytest.mark.parametrize("ref_target", REF_TARGETS)
@pytest.mark.parametrize("target", TARGETS)
def test_recurrent_block_prefill_and_decode_match_reference(
        rng, target, ref_target):
    jcfg, tcfg = _f32("recurrentgemma-9b")
    p = _block_params(jrg.recurrent_block_spec, "recurrentgemma-9b", 3)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    with juse(JOptions(target=ref_target)):
        want = jrg.apply_recurrent_block(p, x, jcfg, return_state=True)
        st = {"conv": want[1]["conv"].astype(jnp.float32),
              "h": want[1]["h"]}
        want_dec = jrg.apply_recurrent_block(p, x1, jcfg, state=st)
    tp = from_numpy_tree(p, "cpu")
    before = trg_kernel.rglru_scan.plain_calls
    with tuse(TOptions(target=target, device="cpu")):
        got = trg.apply_recurrent_block(tp, _t(x), tcfg, return_state=True)
        tst = {"conv": got[1]["conv"].float(), "h": got[1]["h"]}
        got_dec = trg.apply_recurrent_block(tp, _t(x1), tcfg, state=tst)
    _close(got, want)
    _close(got_dec, want_dec)
    # the cuda target reaches the kernel wrapper (its plain version on the
    # CPU) for prefill and for the decode step
    calls = trg_kernel.rglru_scan.plain_calls - before
    assert calls == (2 if target == "cuda" else 0)


def test_causal_conv_tail_is_cast_to_the_input_dtype(rng):
    x = _t(rng.standard_normal((2, 6, 8)).astype(np.float32)).bfloat16()
    w = _t(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.zeros(8)
    tail = _t(rng.standard_normal((2, 3, 8)).astype(np.float32))
    out, new_tail = trg._causal_conv1d(x, w, b, tail)
    assert out.dtype == torch.bfloat16 and new_tail.dtype == torch.bfloat16
    assert torch.equal(new_tail, x[:, -3:])
    jout, jtail = jrg._causal_conv1d(jnp.asarray(x.float().numpy()),
                                     jnp.asarray(w.numpy()),
                                     jnp.asarray(b.numpy()),
                                     jnp.asarray(tail.numpy()))
    out32, tail32 = trg._causal_conv1d(x.float(), w, b, tail)
    np.testing.assert_allclose(out32.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tail32.numpy(), np.asarray(jtail), **TOL)


def test_group_norm_uses_the_population_variance(rng):
    x = rng.standard_normal((2, 3, 32)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(32).astype(np.float32)
    got = trwkv._group_norm(_t(x), _t(s), 4)
    want = jrwkv._group_norm(jnp.asarray(x), jnp.asarray(s), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
