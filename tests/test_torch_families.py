"""The MoE, encoder-decoder and vision families and the seven configs
that carry them, held to the JAX reference on the CPU.

The seven configs (grok-1-314b and arctic-480b: ``moe``; whisper-base:
``encdec``, its audio frames given; qwen2-vl-2b: ``dense`` with the
vision prefix and M-RoPE; starcoder2-15b, qwen1.5-32b, qwen3-32b:
``dense``), reduced, at f32 compute, the port's weights converted from
the reference's ``init(0)`` with seeded noise on every leaf (so the
zero-initialized biases take part); whisper with the reference's seeded
audio frames, qwen2-vl with its 256-patch vision prefix and M-RoPE
streams.  On both port targets (``cuda``,
whose wrappers run their plain versions on CPU tensors, and ``torch``):

* ``forward_train``'s logits within 1e-5 of their largest entry and the
  loss within 1e-5 relative (the MoE's aux loss in it);
* every gradient within 1e-4 of its leaf's largest entry, and three
  ``make_train_step`` steps' losses within 1e-4 relative, with the first
  step's moments and master params at ``tests/test_torch_train.py``'s
  bars;
* greedy prefill plus decode: every step's logits within 1e-5 of their
  largest entry and the tokens equal;
* grok-1-314b through ``serve_paged`` in ``continuous`` and
  ``prefill_chunk`` modes: the tokens of the reference's engine on
  ``xla`` and ``pallas``;
* the port's grok-1-314b is the published model and the reference's is
  not: the port's config is held to the reference's as its twin
  (``tests/jax_twin.py``: grok-1's published parts off, and the logit
  cap off in both, since the reference's decode drops it); the port's
  decode step and chunked prefill cap as its forward does
  (``tests/test_torch_grok.py`` holds the published model to the plain
  reference).

Then the configs and specs of all ten architectures, the serving CLI on
the CPU for each new architecture, and the two examples.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import all_arch_ids as jall_ids  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.options import CompileOptions as JOptions  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import lm_loss as jlm_loss  # noqa: E402
from repro.optim import OptimizerConfig as JOptConfig  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.configs import all_arch_ids as tall_ids  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOptConfig  # noqa: E402
from repro_torch.optim import init_opt_state as tinit_opt  # noqa: E402

from jax_twin import PORT_ONLY, shared_fields, twin, uncapped  # noqa: E402


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
NEW = ("grok-1-314b", "arctic-480b", "starcoder2-15b", "qwen1.5-32b",
       "qwen3-32b", "qwen2-vl-2b", "whisper-base")
TARGETS = ("cuda", "torch")
ON_CPU = {t: TOptions(target=t, device="cpu") for t in TARGETS}
B, S, GEN = 2, 12, 4


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _near(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=str(what))


def _frontend(cfg, batch: int) -> dict:
    """The frontend stub's inputs: whisper's audio frames as the
    reference's ``generate`` draws them (``default_rng(0)``), qwen2-vl's
    256-patch prefix with its (t, h, w) M-RoPE streams
    (``models/frontends.py``)."""
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio":
        return {"audio_frames": rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision":
        return {"vision_embeds": rng.standard_normal(
                    (batch, jfront.VISION_PATCHES, cfg.d_model))
                .astype(np.float32),
                "vision_positions": np.ascontiguousarray(
                    jfront.make_vision_positions(batch))}
    return {}


def _seq(cfg) -> int:
    """Prompt positions: S text tokens after the vision prefix, if any."""
    return S + (jfront.VISION_PATCHES if cfg.frontend == "vision" else 0)


def _twins(arch):
    """The reduced config in both packages, at f32 compute, the port's
    as the reference computes it (``jax_twin``)."""
    return (jbuild(_f32(uncapped(jget_config(arch, reduced=True)))),
            tbuild(_f32(twin(tget_config(arch, reduced=True), cap=False))))


@pytest.fixture(scope="module", params=NEW)
def models(request):
    arch = request.param
    jm, tm = _twins(arch)
    rng = np.random.default_rng(11)
    host = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32),
        jax.device_get(jsteps.cast_compute(jm.init(0), "float32")))
    toks = rng.integers(0, tm.cfg.vocab_size,
                        (B, _seq(tm.cfg) + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                     # ignored positions
    batch = {"tokens": toks[:, :-1], "labels": labels,
             **_frontend(tm.cfg, B)}
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits, aux = jm.forward(p, jbatch, remat_policy="none")
        return jlm_loss(logits, jbatch["labels"]) + 0.01 * aux, \
            (logits, aux)
    (jl, (jlogits, jaux)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp)
    return {"arch": arch, "jm": jm, "tm": tm, "host": host, "jp": jp,
            "batch": batch, "logits": np.asarray(jlogits),
            "aux": float(jaux), "loss": float(jl),
            "grads": jax.device_get(jg)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_params(m):
    return model_params_from_numpy(m["host"], m["tm"].cfg, "cpu")


# ---------------------------------------------------------------------------
# training: forward, gradients, the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
def test_forward_and_loss_match_reference(models, target):
    m = models
    tm = m["tm"]
    params = _port_params(m)
    batch = _torch_batch(m["batch"])
    with tuse(ON_CPU[target]), torch.no_grad():
        logits, aux = tm.forward(params, batch)
        loss = tm.loss(params, batch)
    assert logits.shape == (B, _seq(tm.cfg), tm.cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _near(logits.numpy(), m["logits"], 1e-5, (m["arch"], "logits"))
    np.testing.assert_allclose(float(aux), m["aux"], rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (tm.cfg.family == "moe")
    np.testing.assert_allclose(float(loss), m["loss"], rtol=1e-5)


def test_grads_match_reference(models):
    m = models
    tm = m["tm"]
    params = _port_params(m)
    leaves = [p.requires_grad_() for _, p in tree_leaves_with_path(params)]
    with tuse(ON_CPU["cuda"]):
        loss = tm.loss(params, _torch_batch(m["batch"]))
        grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), m["loss"], rtol=1e-5)
    want = dict(tree_leaves_with_path(m["grads"]))
    paths = [path for path, _ in tree_leaves_with_path(params)]
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        assert float(g.abs().max()) > 0, path       # every leaf takes part
        _near(g.numpy(), want[path], 1e-4, path)


STEPS = 3


def test_train_step_matches_reference(models):
    """Three steps from one carried state on the same batch: the losses
    within 1e-4 relative; after the first, the moments ((1 - b1) · g) to
    1e-4 of each leaf's scale and the master params to 1e-5 of it (bar
    entries whose gradient lies within that 1e-4 of zero, held to
    AdamW's largest first step, 2 · lr: ``tests/test_torch_train.py``)."""
    m = models
    jm, tm = m["jm"], m["tm"]
    jhp, thp = (steps.TrainHParams(
        optimizer=opt(lr=1e-3, warmup_steps=1, total_steps=STEPS),
        remat_policy="none", compute_dtype="float32")
        for steps, opt in ((jsteps, JOptConfig), (tsteps, TOptConfig)))
    jstate = {"params": m["jp"], "opt": jinit_opt(m["jp"], jhp.optimizer)}
    tp = _port_params(m)
    tstate = {"params": tp, "opt": tinit_opt(tp, thp.optimizer)}
    jstep = jax.jit(jsteps.make_train_step(jm, jhp))
    tstep = tsteps.make_train_step(tm, thp)
    jbatch = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    for i in range(STEPS):
        jstate, jmet = jstep(jstate, jbatch)
        with tuse(ON_CPU["cuda"]):
            tstate, tmet = tstep(tstate, _torch_batch(m["batch"]))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        if i:
            continue
        lr = float(jmet["lr"])
        want_p = dict(tree_leaves_with_path(jax.device_get(
            jstate["params"])))
        want_m = dict(tree_leaves_with_path(jax.device_get(
            jstate["opt"]["m"])))
        got_m = dict(tree_leaves_with_path(tstate["opt"]["m"]))
        for path, p in tree_leaves_with_path(tstate["params"]):
            _near(got_m[path].numpy(), want_m[path], 1e-4, path)
            got, want = p.numpy(), want_p[path]
            g = np.abs(want_m[path])
            well = g > 1e-4 * g.max(initial=0.0)
            d = np.abs(got - want)
            scale = float(np.abs(want).max(initial=0.0))
            assert (d[well] <= 1e-5 * scale).all(), path
            assert (d[~well] <= 2 * lr + 1e-5 * scale).all(), path
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# serving: prefill + greedy decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
def test_greedy_prefill_and_decode_match_reference(models, target):
    m = models
    jm, tm, jp = m["jm"], m["tm"], m["jp"]
    cfg = tm.cfg
    plen = _seq(cfg)
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, plen)).astype(np.int32)
    batch = {"tokens": prompts, **_frontend(cfg, B)}
    max_len = plen + GEN
    jprefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))
    jdecode = jax.jit(jm.decode_step)
    jlogits, jcache = jprefill(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tp = _port_params(m)
    with tuse(ON_CPU[target]):
        tlogits, tcache = tm.prefill(tp, _torch_batch(batch),
                                     max_len=max_len)
        length = plen
        for step in range(GEN):
            _near(tlogits.numpy(), jlogits, 1e-5, (m["arch"], step))
            jtok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab_size], -1),
                              np.int32)
            ttok = torch.argmax(tlogits[:, :cfg.vocab_size], -1) \
                .to(torch.int32)
            np.testing.assert_array_equal(ttok.numpy(), jtok)
            jlogits, jcache = jdecode(jp, jnp.asarray(jtok), jcache,
                                      jnp.int32(length))
            tlogits, tcache = tm.decode_step(tp, ttok, tcache, length)
            length += 1
    _near(tlogits.numpy(), jlogits, 1e-5, (m["arch"], GEN))
    if cfg.family == "encdec":
        for key in ("cross_k", "cross_v"):
            assert tcache[key].shape == (cfg.n_layers, B, cfg.encoder_seq,
                                         cfg.n_kv_heads, cfg.head_dim)
            _near(tcache[key].numpy(), jcache[key], 1e-5, key)


def test_whisper_generate_draws_the_reference_audio_frames():
    """``generate`` gives an audio model the reference's frames
    (``default_rng(0)``, or the serving loop's generator after its
    prompts), so the greedy tokens equal the reference's."""
    jm = jbuild(_f32(jget_config("whisper-base", reduced=True)))
    tm = tbuild(_f32(tget_config("whisper-base", reduced=True)))
    jp = jsteps.cast_compute(jm.init(0), "float32")
    tp = model_params_from_numpy(jax.device_get(jp), tm.cfg, "cpu")
    prompts = np.random.default_rng(4).integers(
        1, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    for rng in (None, 9):
        kw = lambda: {} if rng is None else {
            "rng": np.random.default_rng(rng)}
        want = jserve.generate(jm, jp, prompts, gen_len=5, max_len=10,
                               **kw())
        with tuse(ON_CPU["cuda"]):
            got = tserve.generate(tm, tp, prompts, gen_len=5, max_len=10,
                                  **kw())
        np.testing.assert_array_equal(got, want)


def test_frontend_stubs_match_reference():
    for batch in (1, 3):
        np.testing.assert_array_equal(tfront.make_vision_positions(batch),
                                      jfront.make_vision_positions(batch))
    assert (tfront.VISION_PATCHES, tfront.AUDIO_FRAMES) == \
        (jfront.VISION_PATCHES, jfront.AUDIO_FRAMES)
    for arch in ("qwen2-vl-2b", "whisper-base"):
        for reduced in (False, True):
            tcfg = tget_config(arch, reduced=reduced)
            jcfg = jget_config(arch, reduced=reduced)
            for tf, jf in ((tfront.vision_embed_spec,
                            jfront.vision_embed_spec),
                           (tfront.audio_frame_spec,
                            jfront.audio_frame_spec)):
                shape, dtype = tf(tcfg, 2)
                want = jf(jcfg, 2)
                assert shape == tuple(want.shape)
                assert str(dtype).removeprefix("torch.") == str(want.dtype)
    shape, dtype = tfront.vision_position_spec(2)
    want = jfront.vision_position_spec(2)
    assert shape == tuple(want.shape) and dtype == torch.int32


# ---------------------------------------------------------------------------
# grok-1-314b on the paged engine, and the reference's uncapped decode
# ---------------------------------------------------------------------------

PAGED_MODES = {"continuous": {"n_slots": 2, "block_size": 4,
                              "num_blocks": 16},
               "prefill_chunk": {"n_slots": 2, "block_size": 4,
                                 "num_blocks": 16, "prefill_chunk": 4}}


@pytest.fixture(scope="module")
def grok():
    jm, tm = _twins("grok-1-314b")
    jp = jsteps.cast_compute(jm.init(0), "float32")
    tp = model_params_from_numpy(jax.device_get(jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


def _tokens(res):
    return {r.rid: list(r.tokens) for r in res["requests"]}


@pytest.mark.parametrize("ref_target", ["xla", "pallas"])
@pytest.mark.parametrize("mode", sorted(PAGED_MODES))
def test_grok_serve_paged_matches_reference(grok, mode, ref_target):
    jm, jp, tm, tp = grok
    kw = PAGED_MODES[mode]
    want = jserve.serve_paged(
        jm, jp, jserve.make_requests(5, prompt_len=11, gen_len=6,
                                     vocab=jm.cfg.vocab_size, seed=3,
                                     ragged=True),
        options=JOptions(target=ref_target), **kw)
    got = tserve.serve_paged(
        tm, tp, tserve.make_requests(5, prompt_len=11, gen_len=6,
                                     vocab=tm.cfg.vocab_size, seed=3,
                                     ragged=True),
        options=ON_CPU["cuda"], **kw)
    assert _tokens(got) == _tokens(want)
    assert got["steps"] == want["steps"]


def test_grok_decode_and_chunked_prefill_cap_as_its_forward_does():
    """The port's published grok-1 caps its attention logits in every
    path: at a cap of 0.5 (so capping moves the logits far), its decode
    step and its paged chunked prefill equal its forward over the same
    positions, and a forward with no cap differs from both."""
    tm = tbuild(_f32(dataclasses.replace(
        tget_config("grok-1-314b", reduced=True), attn_logit_softcap=0.5)))
    free = tbuild(dataclasses.replace(tm.cfg, attn_logit_softcap=None))
    tp = tm.init(0, "cpu")
    P = 8
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        1, tm.cfg.vocab_size, (1, P + 1)).astype(np.int32))
    with tuse(ON_CPU["cuda"]):
        fwd = tm.forward(tp, {"tokens": prompt})[0][0, -1]
        uncapped_fwd = free.forward(tp, {"tokens": prompt})[0][0, -1]
        _, cache = tm.prefill(tp, {"tokens": prompt[:, :P]}, max_len=P + 1)
        dec = tm.decode_step(tp, prompt[:, P], cache, P)[0][0]
        pools = tm.init_paged_cache(6, 4, device="cpu")
        for start in (0, 4, 8):
            chunk, pools = tm.paged_prefill_chunk(
                tp, prompt[0, start:start + 4], start, pools,
                torch.tensor([1, 2, 3, 0], dtype=torch.int32), block_size=4)
    fwd = fwd.detach().numpy()
    for other in (dec, chunk):
        _near(other.detach().numpy(), fwd, 1e-5, "capped")
    assert np.abs(uncapped_fwd.detach().numpy() - fwd).max() > \
        1e-2 * np.abs(fwd).max()


# ---------------------------------------------------------------------------
# configs, specs, the CLI, the examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jall_ids())
def test_configs_and_specs_match_reference(arch):
    """Every field of the published and the reduced config, and the
    parameter tree's paths, shapes, logical axes and init kinds, so
    ``model_params_from_numpy`` takes the reference's tree: the port's
    as its twin (``jax_twin``), whose fields the reference lacks are at
    their defaults."""
    assert tall_ids() == jall_ids()
    defaults = {f.name: f.default for f in dataclasses.fields(
        tget_config(arch))}
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        tcfg = twin(tget_config(arch, reduced=reduced))
        assert shared_fields(tcfg) == dataclasses.asdict(jcfg)
        assert {k: getattr(tcfg, k) for k in PORT_ONLY} == \
            {k: defaults[k] for k in PORT_ONLY}
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        want = {path: (tuple(s.shape), tuple(s.axes), s.init)
                for path, s in tree_leaves_with_path(jm.spec)}
        got = {path: (tuple(s.shape), tuple(s.axes), s.init)
               for path, s in tree_leaves_with_path(tm.spec)}
        assert got == want
        assert tm.n_params() == jm.n_params()
        assert tm.n_active_params() == jm.n_active_params()


def test_init_in_a_dtype_draws_layer_by_layer():
    """``init(dtype=...)`` makes the floating leaves in that dtype from the
    draws of ``init()``, whose stacked leaves are drawn one layer at a
    time: the f32 tree equals ``init()``'s, a bf16 tree is its cast, every
    leaf has its spec's shape, and each layer of a stacked weight has its
    init's scale."""
    tm = tbuild(tget_config("grok-1-314b", reduced=True))
    plain = tm.init(0, "cpu")
    f32 = tm.init(0, "cpu", dtype="float32")
    for (path, a), b in zip(tree_leaves_with_path(f32),
                            tree_leaves(plain)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    want = dict(tree_leaves_with_path(tsteps.cast_compute(f32, "bfloat16")))
    spec = dict(tree_leaves_with_path(tm.spec))
    got = tm.init(0, "cpu", dtype=torch.bfloat16)
    for path, a in tree_leaves_with_path(got):
        assert a.dtype == torch.bfloat16 and torch.equal(a, want[path]), path
        assert tuple(a.shape) == spec[path].shape, path
    w = dict(tree_leaves_with_path(f32))[("layers", "moe", "w_up")]
    for layer in w:
        assert abs(float(layer.std()) * tm.cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not torch.equal(w[0], w[1])


@pytest.mark.parametrize("arch", NEW)
def test_cli_serves_each_new_arch_on_the_cpu(arch):
    """``--paged`` for the families with a KV cache to page; whisper
    through the wave loop (``--paged`` raises for it, as in the
    reference)."""
    paged = tget_config(arch).family in ("dense", "moe")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "6",
                          "--gen-len", "3"] + (["--paged"] if paged else []))
    assert rc == 0
    line = buf.getvalue()
    assert ("[serve:continuous] 2 requests" if paged
            else "[serve] 2 requests, 6 tokens") in line, line


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "grok-1-314b",
                                  "whisper-base"])
def test_serve_example_runs_on_the_cpu(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("serve_lm_torch").main(
            ["--device", "cpu", "--arch", arch, "--requests", "3",
             "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    last = buf.getvalue().strip().splitlines()[-1]
    assert re.fullmatch(r"\[example\] served 3 requests \(9 tokens\) at "
                        r"[\d.]+ tok/s \(kv cache: bf16\)", last), last


def test_train_example_runs_on_the_cpu_and_its_loss_falls():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("train_lm_torch").main(
            ["--device", "cpu", "--arch", "arctic-480b", "--steps", "20",
             "--batch", "4", "--seq", "32"])
    lines = buf.getvalue().strip().splitlines()
    assert re.fullmatch(r"\[example\] arctic-480b-reduced: [\d,]+ params",
                        lines[0]), lines[0]
    m = re.fullmatch(r"\[example\] loss ([\d.]+) → ([\d.]+) over 20 steps "
                     r"\(restarts=0, stragglers=\d+\)", lines[-1])
    assert m, lines[-1]
    assert float(m.group(2)) < float(m.group(1))
