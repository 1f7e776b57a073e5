"""Serving the recurrent families, held to the JAX reference on the CPU.

rwkv6-3b and recurrentgemma-9b, reduced, at f32 compute, the port's
weights converted from the reference's ``init(0)`` with seeded noise on
every leaf (so the zero-initialized low-rank parts take part): the wave
loop's greedy tokens (``launch.serve.generate``) equal the reference's
on ``xla`` and on ``pallas`` in interpret mode, request for request, on
both port targets; prefill and one decode step agree in the logits and
in every cache leaf to 1e-5 of the leaf's scale.  The hybrid's prompt
and generation together pass its window of 16, so its ring wraps; a
prompt longer than the window exercises the prefill's roll into the
ring.  Also: the trees
convert, the CLI serves both on the CPU, and ``--paged`` raises as the
reference does.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.core.options import use_options as juse  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rglru as trg  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import rwkv6 as trw  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402

ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
REF_TARGETS = ("xla", "pallas")
TARGETS = ("cuda", "torch")
TOL = dict(rtol=1e-5, atol=1e-5)
# (batch, prompt length, new tokens): the hybrid's 12 + 8 = 20 > window 16
GEN = {"rwkv6-3b": (3, 9, 6), "recurrentgemma-9b": (2, 12, 8)}
# (prompt length, max_len) of the prefill / decode-step comparison; the
# hybrid's 20-token prompt is longer than its window
STEP = {"rwkv6-3b": (7, 8), "recurrentgemma-9b": (20, 24)}
WRAPPERS = (trw.rwkv6_scan, trg.rglru_scan, trn.rmsnorm,
            tfa.flash_attention, tda.decode_attention)


def _prompts(arch, vocab, batch, length, seed):
    return np.random.default_rng(seed).integers(
        1, vocab, (batch, length)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tget_config(arch, reduced=True),
                               compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    rng = np.random.default_rng(11)
    host = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32),
        jax.device_get(jsteps.cast_compute(jm.init(0), "float32")))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = model_params_from_numpy(host, tcfg, "cpu")
    return arch, jm, jp, tm, tp, host


@pytest.fixture(scope="module")
def reference_runs(models):
    """Per reference target: the greedy tokens of ``generate`` and the
    prefill and one decode step's (logits, cache), once per module."""
    arch, jm, jp, _, _, _ = models
    vocab = jm.cfg.vocab_size
    b, s, g = GEN[arch]
    prompts = _prompts(arch, vocab, b, s, 0)
    ps, max_len = STEP[arch]
    step_prompt = _prompts(arch, vocab, 2, ps, 1)
    out = {}
    for target in REF_TARGETS:
        with juse(JOptions(target=target)):
            tokens = jserve.generate(jm, jp, prompts, gen_len=g,
                                     max_len=s + g)
            logits, cache = jm.prefill(
                jp, {"tokens": jnp.asarray(step_prompt)}, max_len=max_len)
            tok = jnp.argmax(logits[:, :vocab], -1).astype(jnp.int32)
            dlogits, dcache = jm.decode_step(jp, tok, cache, jnp.int32(ps))
        out[target] = {"tokens": np.asarray(tokens),
                       "prefill": jax.device_get((logits, cache)),
                       "decode": jax.device_get((dlogits, dcache)),
                       "tok": np.asarray(tok)}
    return out


def _close(got, want, path=()):
    """Every leaf to 1e-5 of its own scale: the WKV state reaches ~25,
    and both packages sum its f32 terms in their own order (the first
    layer's state differs by ~2e-7 of its largest entry, the second, fed
    the first's rounding, by ~1.3e-6)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _close(got[key], want[key], path + (key,))
    else:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == torch.float32, path
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("ref_target", REF_TARGETS)
@pytest.mark.parametrize("target", TARGETS)
def test_generate_tokens_match_reference(models, reference_runs, target,
                                         ref_target):
    arch, _, _, tm, tp, _ = models
    b, s, g = GEN[arch]
    prompts = _prompts(arch, tm.cfg.vocab_size, b, s, 0)
    for w in WRAPPERS:
        w.launches = w.plain_calls = 0
    with tuse(TOptions(target=target, device="cpu")):
        got = tserve.generate(tm, tp, prompts, gen_len=g, max_len=s + g)
    np.testing.assert_array_equal(got, reference_runs[ref_target]["tokens"])
    assert all(w.launches == 0 for w in WRAPPERS)   # the CPU: plain only
    scan = trw.rwkv6_scan if arch == "rwkv6-3b" else trg.rglru_scan
    assert (scan.plain_calls > 0) == (target == "cuda")
    if arch == "recurrentgemma-9b":
        assert s + g > tm.cfg.window          # the ring wrapped
        assert (tda.decode_attention.plain_calls > 0) == (target == "cuda")


@pytest.mark.parametrize("ref_target", REF_TARGETS)
@pytest.mark.parametrize("target", TARGETS)
def test_prefill_and_decode_step_match_reference(models, reference_runs,
                                                 target, ref_target):
    arch, _, _, tm, tp, _ = models
    ps, max_len = STEP[arch]
    prompt = _prompts(arch, tm.cfg.vocab_size, 2, ps, 1)
    want = reference_runs[ref_target]
    with tuse(TOptions(target=target, device="cpu")):
        logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                                   max_len=max_len)
        _close(logits, want["prefill"][0])
        _close(cache, want["prefill"][1])
        tok = torch.from_numpy(want["tok"].copy())
        dlogits, dcache = tm.decode_step(tp, tok, cache, ps)
    _close(dlogits, want["decode"][0])
    _close(dcache, want["decode"][1])


def test_init_cache_matches_reference_layout(models):
    arch, jm, _, tm, _, _ = models
    want = jax.eval_shape(lambda: jm.init_cache(3, 40))
    got = tm.init_cache(3, 40, device="cpu")
    got_leaves = dict(tree_leaves_with_path(got))
    want_leaves = {tuple(getattr(k, "key", k) for k in path): leaf for
                   path, leaf in jax.tree_util.tree_flatten_with_path(
                       want)[0]}
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, t in got_leaves.items():
        assert tuple(t.shape) == want_leaves[path].shape, path
        assert str(t.dtype).split(".")[1] == str(want_leaves[path].dtype)
        assert not t.any()


def test_convert_takes_the_reference_tree(models):
    arch, jm, jp, tm, tp, host = models
    spec = dict(tree_leaves_with_path(tm.spec))
    got = dict(tree_leaves_with_path(tp))
    want = dict(tree_leaves_with_path(host))
    assert sorted(got) == sorted(spec) == sorted(want)
    assert tm.n_params() == jm.n_params()
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path])
    top = "layers" if arch == "rwkv6-3b" else "groups"
    bad = {k: v for k, v in host.items() if k != top}
    with pytest.raises(ValueError, match="model_spec"):
        model_params_from_numpy(bad, tm.cfg, "cpu")


def test_port_init_is_seeded_with_the_reference_spec(models):
    _, _, _, tm, _, _ = models
    a, b = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("target", TARGETS)
def test_cli_wave_loop_serves_the_reduced_model_on_the_cpu(models, target):
    arch = models[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--target", target, "--requests", "2",
                          "--prompt-len", "6", "--gen-len", "4"])
    assert rc == 0 and "[serve] 2 requests, 8 tokens" in buf.getvalue()


def test_paged_raises_as_the_reference_does(models):
    arch = models[0]
    argv = ["--arch", arch, "--reduced", "--paged", "--requests", "1",
            "--prompt-len", "4", "--gen-len", "2"]
    with pytest.raises(NotImplementedError) as ref_err:
        jserve.main(argv)
    with pytest.raises(NotImplementedError) as port_err:
        tserve.main(argv + ["--device", "cpu"])
    assert str(port_err.value) == str(ref_err.value)
    assert "paged KV cache supports dense/moe families" in str(port_err.value)
