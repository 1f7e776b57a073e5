"""The serving slice as a whole, held to the JAX reference on the CPU.

The port's continuous-batching engine (``repro_torch.launch.serve.
serve_paged``, target ``cuda`` on the CPU, hence every kernel's plain
version) and the reference's (on ``xla`` and on ``pallas`` in interpret
mode) serve the same requests with the same converted weights at f32
compute: the greedy tokens must be equal request for request in every
engine mode — continuous, static, chunked prefill, lazy allocation with
preemption to the swap arena, prefix sharing and the int8 KV cache —
and one paged decode step's logits must agree to 1e-5.  The port's
paged engine is also held to its own contiguous ``generate``, as
``tests/test_serve_paged.py`` holds the reference's.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import serve as jserve_mod  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.runtime.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_kv as tpk  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import serve as tserve_mod  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402
from repro_torch.runtime.scheduler import Request as TRequest  # noqa: E402

ON_CPU = TOptions(target="cuda", device="cpu")
WRAPPERS = (tfa.flash_attention, tda.decode_attention, trn.rmsnorm,
            tpk.page_gather)


def _shared_prompt_requests(Req, vocab):
    prompt = np.random.default_rng(5).integers(1, vocab, 6).astype(np.int32)
    return [Req(rid=i, prompt=prompt.copy(), gen_len=4, arrival=0.0)
            for i in range(3)]


def _ragged(mk, vocab):
    return mk(5, prompt_len=11, gen_len=6, vocab=vocab, seed=3, ragged=True)


# mode -> (requests(make_requests, Request, vocab), serve_paged kwargs);
# the lazy and prefix cases are the reference's own preempting / forking
# scenarios (tests/test_serve_paged.py)
MODES = {
    "continuous": (lambda mk, R, v: _ragged(mk, v),
                   {"n_slots": 2, "block_size": 4, "num_blocks": 16}),
    "static": (lambda mk, R, v: _ragged(mk, v),
               {"n_slots": 2, "block_size": 4, "num_blocks": 16,
                "policy": "static"}),
    "prefill_chunk": (lambda mk, R, v: _ragged(mk, v),
                      {"n_slots": 2, "block_size": 4, "num_blocks": 16,
                       "prefill_chunk": 4}),
    "lazy_swap": (lambda mk, R, v: mk(4, prompt_len=4, gen_len=8, vocab=v,
                                      seed=7),
                  {"n_slots": 2, "block_size": 4, "num_blocks": 5,
                   "lazy_alloc": True}),
    "prefix_share": (lambda mk, R, v: _shared_prompt_requests(R, v),
                     {"n_slots": 3, "block_size": 4, "num_blocks": 16,
                      "max_prefill_per_step": 3, "prefix_share": True}),
    "quantized": (lambda mk, R, v: _ragged(mk, v),
                  {"n_slots": 2, "block_size": 4, "num_blocks": 16,
                   "quantized": True}),
}
REF_TARGETS = ("xla", "pallas")
TELEMETRY = ("preemptions", "forks", "shared_block_hits", "peak_active")


@pytest.fixture(scope="module")
def models():
    """The reduced qwen2-1.5b at f32 compute in both packages, the port's
    weights converted from the reference's ``init(0)``."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", reduced=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b", reduced=True),
                               compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jsteps.cast_compute(jm.init(0), "float32")
    tp = model_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def reference_runs(models):
    """Every mode on both reference targets, once per module."""
    jm, jp, _, _ = models
    out = {}
    for target in REF_TARGETS:
        for mode, (make, kw) in MODES.items():
            reqs = make(jserve.make_requests, JRequest, jm.cfg.vocab_size)
            res = jserve.serve_paged(jm, jp, reqs,
                                     options=JOptions(target=target), **kw)
            out[target, mode] = res
    return out


def _tokens(res):
    return {r.rid: list(r.tokens) for r in res["requests"]}


@pytest.mark.parametrize("target", REF_TARGETS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_paged_tokens_match_reference(models, reference_runs, mode,
                                            target):
    _, _, tm, tp = models
    make, kw = MODES[mode]
    for w in WRAPPERS:
        w.launches = 0
    got = tserve.serve_paged(
        tm, tp, make(tserve.make_requests, TRequest, tm.cfg.vocab_size),
        options=ON_CPU, **kw)
    want = reference_runs[target, mode]
    assert _tokens(got) == _tokens(want), (mode, target)
    assert got["steps"] == want["steps"]
    for key in TELEMETRY:
        assert got["telemetry"][key] == want["telemetry"][key], key
    assert got["telemetry"]["allocator"] == want["telemetry"]["allocator"]
    if mode == "lazy_swap":
        assert got["telemetry"]["preemptions"] >= 1
    if mode == "prefix_share":
        assert got["telemetry"]["forks"] >= 1
    assert all(w.launches == 0 for w in WRAPPERS)   # the CPU: plain only


def test_serve_telemetry_schema_matches_reference(models, reference_runs):
    _, _, tm, tp = models
    make, kw = MODES["lazy_swap"]
    got = tserve.serve_paged(
        tm, tp, make(tserve.make_requests, TRequest, tm.cfg.vocab_size),
        options=ON_CPU, **kw)
    want = reference_runs["xla", "lazy_swap"]
    assert sorted(got) == sorted(want)
    tel, ref_tel = got["telemetry"], want["telemetry"]
    assert sorted(tel) == sorted(ref_tel)
    for key in ("allocator", "swap", "engine_cache"):
        assert sorted(tel[key]) == sorted(ref_tel[key])


def _prefilled_pools(model, params, prompt, bs, n_blocks, scatter, prefill):
    """A prompt prefilled and scattered into block 1.. of fresh pools."""
    logits, cache = prefill(prompt)
    pools = model.init_paged_cache(n_blocks, bs, **(
        {"device": "cpu"} if scatter is tserve_mod.scatter_prefill_paged
        else {}))
    nb = -(-prompt.shape[1] // bs)
    return logits, scatter(pools, cache["kv"], list(range(1, nb + 1)), bs)


@pytest.mark.parametrize("target", ["cuda", "torch"])
def test_paged_decode_step_logits_match_reference(models, target):
    jm, jp, tm, tp = models
    P, bs = 6, 4
    prompt = np.random.default_rng(1).integers(
        1, jm.cfg.vocab_size, (1, P)).astype(np.int32)
    jlogits, jpools = _prefilled_pools(
        jm, jp, prompt, bs, 5, jserve_mod.scatter_prefill_paged,
        lambda t: jm.prefill(jp, {"tokens": jnp.asarray(t)}, max_len=P))
    tok = np.array(jnp.argmax(jlogits[:, :jm.cfg.vocab_size], -1),
                   np.int32)
    table = np.asarray([[1, 2, 3]], np.int32)    # block 3 takes nothing
    lengths = np.asarray([P], np.int32)
    want, _ = jm.paged_decode_step(jp, jnp.asarray(tok), jpools,
                                   jnp.asarray(table), jnp.asarray(lengths),
                                   block_size=bs)
    with tuse(TOptions(target=target, device="cpu")):
        tlogits, tpools = _prefilled_pools(
            tm, tp, prompt, bs, 5, tserve_mod.scatter_prefill_paged,
            lambda t: tm.prefill(tp, {"tokens": torch.from_numpy(t)},
                                 max_len=P))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
        got, _ = tm.paged_decode_step(tp, torch.from_numpy(tok), tpools,
                                      torch.from_numpy(table),
                                      torch.from_numpy(lengths),
                                      block_size=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_engine_matches_its_contiguous_generate(models, quantized):
    _, _, tm, tp = models
    reqs = tserve.make_requests(5, prompt_len=4, gen_len=4,
                                vocab=tm.cfg.vocab_size, seed=3, ragged=True)
    out = tserve.serve_paged(tm, tp, reqs, n_slots=2, block_size=4,
                             num_blocks=7, quantized=quantized,
                             options=ON_CPU)
    with tuse(ON_CPU):
        for r in out["requests"]:
            want = tserve.generate(tm, tp, np.asarray(r.prompt)[None],
                                   gen_len=r.gen_len,
                                   max_len=r.prompt_len + r.gen_len,
                                   quantized=quantized)[0].tolist()
            assert r.tokens == want, r.rid


def test_chunked_prefill_logits_match_monolithic(models):
    _, _, tm, tp = models
    bs = 4
    prompt = np.random.default_rng(2).integers(
        1, tm.cfg.vocab_size, 11).astype(np.int32)
    row = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    with tuse(ON_CPU):
        want, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[None])},
                             max_len=11)
        pools = tm.init_paged_cache(8, bs, device="cpu")
        start = 0
        for size in (4, 4, 3):
            got, pools = tm.paged_prefill_chunk(
                tp, torch.from_numpy(prompt[start:start + size]), start,
                pools, row, block_size=bs)
            start += size
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sampling_is_seeded_and_differs_across_seeds(models):
    _, _, tm, tp = models

    def run(seed):
        reqs = tserve.make_requests(3, prompt_len=4, gen_len=6,
                                    vocab=tm.cfg.vocab_size, seed=0)
        out = tserve.serve_paged(tm, tp, reqs, n_slots=2, block_size=4,
                                 num_blocks=12, greedy=False, seed=seed,
                                 options=ON_CPU)
        return _tokens(out)

    assert run(0) == run(0)
    assert run(0) != run(1)


# ---------------------------------------------------------------------------
# weights, CLI and device safety
# ---------------------------------------------------------------------------

def test_convert_round_trips_the_reference_tree(models):
    jm, jp, tm, tp = models
    spec = dict(tree_leaves_with_path(tm.spec))
    got = dict(tree_leaves_with_path(tp))
    want = dict(tree_leaves_with_path(jax.device_get(jp)))
    assert sorted(got) == sorted(spec) == sorted(want)
    for path, t in got.items():
        assert tuple(t.shape) == tuple(spec[path].shape) == want[path].shape
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))
    bf16 = model_params_from_numpy(
        jax.device_get(jsteps.cast_compute(jp, "bfloat16")), tm.cfg, "cpu")
    assert all(t.dtype == torch.bfloat16
               for _, t in tree_leaves_with_path(bf16))
    with pytest.raises(ValueError, match="model_spec"):
        model_params_from_numpy({"embed": {"table": np.zeros((2, 2))}},
                                tm.cfg, "cpu")


def test_port_init_keeps_the_reference_spec(models):
    jm, _, tm, _ = models
    params = tm.init(0, device="cpu")
    again = tm.init(0, device="cpu")
    for (path, t), (_, t2) in zip(tree_leaves_with_path(params),
                                  tree_leaves_with_path(again)):
        assert torch.equal(t, t2), path          # seeded
    assert tm.n_params() == jm.n_params()
    assert float(params["final_norm"]["scale"].sum()) == tm.cfg.d_model


@pytest.mark.parametrize("target", ["cuda", "torch"])
def test_cli_serves_the_reduced_model_on_the_cpu(target):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--paged",
                          "--device", "cpu", "--target", target,
                          "--requests", "3", "--prompt-len", "8",
                          "--gen-len", "3", "--prefill-chunk", "16"])
    assert rc == 0
    assert "[serve:continuous] 3 requests, 9 tokens" in buf.getvalue()


def test_cli_wave_loop_runs_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                          "cpu", "--requests", "2", "--prompt-len", "4",
                          "--gen-len", "2"])
    assert rc == 0 and "[serve] 2 requests, 4 tokens" in buf.getvalue()


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs for real")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.main(["--arch", "qwen2-1.5b", "--reduced", "--paged"])


def test_params_on_another_device_than_the_engine_raise(models):
    _, _, tm, tp = models
    reqs = tserve.make_requests(1, prompt_len=4, gen_len=2,
                                vocab=tm.cfg.vocab_size)
    with pytest.raises((ValueError, RuntimeError)):
        tserve.serve_paged(tm, tp, reqs, n_slots=1, block_size=4,
                           num_blocks=4, options=TOptions(target="cuda"))
