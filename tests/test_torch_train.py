"""The port's training path, held to the JAX reference on the CPU.

qwen2-1.5b, rwkv6-3b and recurrentgemma-9b, reduced, at f32 compute,
the port's weights converted from the reference's ``init(0)`` with
seeded noise on every leaf (so the zero-initialized low-rank parts take
part).  On both port targets (``cuda``: the kernel wrappers' autograd
plumbing, which on CPU tensors runs the plain versions; ``torch``):

* ``forward_train``'s logits within 1e-5 of their largest entry and
  ``lm_loss`` within 1e-5 relative of the reference's (``xla``);
* every gradient (autograd against ``jax.grad``) within 1e-4 of its
  leaf's largest entry;
* remat ``nothing`` / ``dots`` / ``dots_no_batch`` give the loss and
  gradients of no remat (to 1e-6), and each layer's forward runs again
  in the backward;
* one ``make_train_step`` from the same carried state gives the same
  first moments ((1 - b1) · g, to 1e-4 of each leaf's scale) and new
  master params within 1e-5 of each leaf's scale (bar entries whose
  gradient is within that 1e-4 of zero, where AdamW's first step
  g / (|g| + eps) is not fixed by the gradients: there, the largest
  step), and 5 steps' losses agree within 1e-4 relative.

Then the port alone: microbatch accumulation equals the monolithic step,
and ``train_loop`` mirrors ``tests/test_train_integration.py`` and
``tests/test_checkpoint.py`` (the loss falls; a crash restores the last
checkpoint and the run ends with an uninterrupted run's losses; a run
resumes from its checkpoint), and the CLI trains on the CPU.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import lm_loss as jlm_loss  # noqa: E402
from repro.optim import OptimizerConfig as JOptConfig  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import (from_numpy_tree,  # noqa: E402
                                 model_params_from_numpy)
from repro_torch.core.options import CompileOptions as TOptions  # noqa: E402
from repro_torch.core.options import use_options as tuse  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOptConfig  # noqa: E402
from repro_torch.optim import init_opt_state as tinit_opt  # noqa: E402


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


ARCHS = ("qwen2-1.5b", "rwkv6-3b", "recurrentgemma-9b")
TARGETS = ("cuda", "torch")
B, S = 2, 24      # past the reduced hybrid's window of 16
ON_CPU = {t: TOptions(target=t, device="cpu") for t in TARGETS}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jm = jbuild(_f32(jget_config(arch, reduced=True)))
    tm = tbuild(_f32(tget_config(arch, reduced=True)))
    rng = np.random.default_rng(11)
    host = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32),
        jax.device_get(jsteps.cast_compute(jm.init(0), "float32")))
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                     # ignored positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):       # Model.loss, with the logits beside it
        logits, aux = jm.forward(p, jbatch, remat_policy="none")
        return jlm_loss(logits, jbatch["labels"]) + 0.01 * aux, logits
    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    return {"arch": arch, "jm": jm, "tm": tm, "host": host, "batch": batch,
            "logits": np.asarray(jlogits), "loss": float(jl),
            "grads": jax.device_get(jg)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _loss_and_grads(m, target, remat="none"):
    """The port's loss and autograd gradients (a path → grad dict)."""
    tm = m["tm"]
    params = model_params_from_numpy(m["host"], tm.cfg, "cpu")
    leaves = [p.requires_grad_() for _, p in tree_leaves_with_path(params)]
    with tuse(ON_CPU[target]):
        loss = tm.loss(params, _torch_batch(m["batch"]), remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves)
    paths = [path for path, _ in tree_leaves_with_path(params)]
    return loss.detach(), dict(zip(paths, grads))


def _near(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=str(what))


def _near_after_first_adam_step(got, want, m, lr, what):
    """Master params after one AdamW step from the same state.  The first
    step moves an entry by lr · g / (|g| + eps): where the gradient lies
    within 1e-4 of the leaf's largest gradient of zero (the band the
    gradients are held to), the step's size is not fixed by the
    gradients' agreement, and such an entry is held to the largest step,
    2 · lr; every other entry to 1e-5 of the leaf's scale.  ``m`` is the
    reference's first moment after the step, (1 - b1) · g."""
    got, want, g = np.asarray(got), np.asarray(want), np.abs(np.asarray(m))
    well = g > 1e-4 * g.max(initial=0.0)
    d = np.abs(got - want)
    scale = float(np.abs(want).max(initial=0.0))
    assert (d[well] <= 1e-5 * scale).all(), (what, d[well].max())
    assert (d[~well] <= 2 * lr + 1e-5 * scale).all(), what


@pytest.mark.parametrize("target", TARGETS)
def test_forward_and_loss_match_reference(models, target):
    m = models
    tm = m["tm"]
    params = model_params_from_numpy(m["host"], tm.cfg, "cpu")
    batch = _torch_batch(m["batch"])
    with tuse(ON_CPU[target]):
        with torch.no_grad():
            logits, aux = tm.forward(params, batch)
            loss = tm.loss(params, batch)
    assert logits.shape == (B, S, tm.cfg.padded_vocab)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _near(logits.numpy(), m["logits"], 1e-5, "logits")
    np.testing.assert_allclose(float(loss), m["loss"], rtol=1e-5)


@pytest.mark.parametrize("target", TARGETS)
def test_grads_match_reference(models, target):
    loss, grads = _loss_and_grads(models, target)
    np.testing.assert_allclose(float(loss), models["loss"], rtol=1e-5)
    want = dict(tree_leaves_with_path(models["grads"]))
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        assert float(g.abs().max()) > 0, path       # every leaf takes part
        _near(g.numpy(), want[path], 1e-4, path)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_gives_the_same_loss_and_grads(models, policy):
    """On the ``cuda`` target, whose wrappers count their calls: the
    layers' RMSNorms run again in the backward under every policy (the
    final norm is outside the layers)."""
    n_norms = 2 * models["tm"].cfg.n_layers + 1
    trn.rmsnorm.plain_calls = 0
    loss0, grads0 = _loss_and_grads(models, "cuda")
    assert trn.rmsnorm.plain_calls == n_norms
    trn.rmsnorm.plain_calls = 0
    loss, grads = _loss_and_grads(models, "cuda", remat=policy)
    assert trn.rmsnorm.plain_calls == 2 * n_norms - 1
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for path, g in grads.items():
        _near(g.numpy(), grads0[path].numpy(), 1e-6, path)


def test_remat_policy_names():
    aten = torch.ops.aten
    assert ttfm._remat_policy("nothing") is None
    assert aten.bmm in ttfm._remat_policy("dots")
    assert aten.mm in ttfm._remat_policy("dots_no_batch") and \
        aten.bmm not in ttfm._remat_policy("dots_no_batch")
    with pytest.raises(KeyError):
        ttfm._remat_policy("everything")


def test_families_not_ported_raise():
    """Every family of the reference is ported (queue A4); a family the
    reference does not model raises, as its ``forward_train`` does."""
    assert ttfm.FAMILIES == ("dense", "moe", "rwkv", "hybrid", "encdec")
    cfg = dataclasses.replace(tget_config("qwen2-1.5b", reduced=True),
                              family="mamba")
    with pytest.raises(ValueError, match="mamba"):
        ttfm.forward_train(
            {}, {"tokens": torch.zeros((1, 2), dtype=torch.int32)}, cfg)
    with pytest.raises(ValueError, match="mamba"):
        ttfm.model_spec(cfg)


# -- the train step -------------------------------------------------------

STEPS = 5


def _hparams(pkg_opt, steps_mod, **kw):
    return steps_mod.TrainHParams(
        optimizer=pkg_opt(lr=1e-3, warmup_steps=1, total_steps=STEPS),
        remat_policy="none", compute_dtype="float32", **kw)


def test_train_step_matches_reference(models):
    m = models
    jm, tm = m["jm"], m["tm"]
    jhp = _hparams(JOptConfig, jsteps)
    thp = _hparams(TOptConfig, tsteps)
    jp = jax.tree_util.tree_map(jnp.asarray, m["host"])
    jstate = {"params": jp, "opt": jinit_opt(jp, jhp.optimizer)}
    tp = model_params_from_numpy(m["host"], tm.cfg, "cpu")
    tstate = {"params": tp, "opt": tinit_opt(tp, thp.optimizer)}
    jstep = jax.jit(jsteps.make_train_step(jm, jhp))
    tstep = tsteps.make_train_step(tm, thp)
    data = SyntheticLMDataset(DataConfig(vocab_size=tm.cfg.vocab_size,
                                         seq_len=S, global_batch=B, seed=3),
                              device="cpu")
    for i in range(STEPS):
        b = data.batch_np(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        with tuse(ON_CPU["cuda"]):
            tstate, tmet = tstep(tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        if i == 0:
            lr = float(jmet["lr"])
            want = {key: dict(tree_leaves_with_path(jax.device_get(tree)))
                    for key, tree in (("p", jstate["params"]),
                                      ("m", jstate["opt"]["m"]))}
            got_m = dict(tree_leaves_with_path(tstate["opt"]["m"]))
            for path, p in tree_leaves_with_path(tstate["params"]):
                assert p.dtype == torch.float32 and not p.requires_grad
                _near(got_m[path].numpy(), want["m"][path], 1e-4, path)
                _near_after_first_adam_step(p.numpy(), want["p"][path],
                                            want["m"][path], lr, path)
            np.testing.assert_allclose(float(tmet["grad_norm"]),
                                       float(jmet["grad_norm"]), rtol=1e-4)
    assert int(tstate["opt"]["step"]) == STEPS


def test_microbatch_accumulation_matches_monolithic():
    cfg = _f32(tget_config("qwen2-1.5b", reduced=True))
    model = tbuild(cfg)
    opt = TOptConfig(total_steps=10, warmup_steps=0, clip_norm=0.0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (8, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    out = {}
    with tuse(ON_CPU["cuda"]):
        for k in (1, 4):
            hp = tsteps.TrainHParams(optimizer=opt, microbatches=k,
                                     remat_policy="none",
                                     compute_dtype="float32")
            state = tsteps.init_train_state(model, hp, 0, device="cpu")
            out[k] = tsteps.make_train_step(model, hp)(state, batch)
    (n1, m1), (n4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    moments = {k: dict(tree_leaves_with_path(new["opt"]["m"]))
               for k, (new, _) in out.items()}
    for (path, a), (_, b) in zip(tree_leaves_with_path(n1["params"]),
                                 tree_leaves_with_path(n4["params"])):
        # the accumulated gradient, (1 - b1) · g, and the step it takes
        _near(moments[4][path].numpy(), moments[1][path].numpy(), 1e-5,
              path)
        _near_after_first_adam_step(b.numpy(), a.numpy(),
                                    moments[1][path].numpy(),
                                    float(m1["lr"]), path)


def test_bf16_compute_takes_bf16_grads_into_an_f32_master():
    cfg = tget_config("qwen2-1.5b", reduced=True)       # bf16 compute
    model = tbuild(cfg)
    hp = tsteps.TrainHParams(optimizer=TOptConfig(warmup_steps=0))
    with tuse(ON_CPU["cuda"]):
        state = tsteps.init_train_state(model, hp, 0, device="cpu")
        batch = _torch_batch(SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
            device="cpu").batch_np(0))
        new, met = tsteps.make_train_step(model, hp)(state, batch)
    for (_, p), (_, q) in zip(tree_leaves_with_path(state["params"]),
                              tree_leaves_with_path(new["params"])):
        assert p.dtype == q.dtype == torch.float32
        assert p.grad is None and not p.requires_grad
    assert np.isfinite(float(met["loss"]))


# -- the loop -------------------------------------------------------------

def test_loss_decreases_reduced_lm():
    cfg = tget_config("qwen2-1.5b", reduced=True)
    with tuse(ON_CPU["cuda"]):
        out = ttrain.train_loop(cfg, steps=40, batch=8, seq=64, log_every=0,
                                hp=tsteps.TrainHParams(
                                    optimizer=TOptConfig(
                                        lr=3e-3, warmup_steps=5,
                                        total_steps=40)))
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)
    assert len(out["step_ms"]) == 40


def test_train_loop_crash_restore_continues(tmp_path):
    """A node failure injected at step 6 restores step 4's checkpoint;
    the run ends at step 12 with the losses of a run that never failed."""
    cfg = tget_config("qwen2-1.5b", reduced=True)
    with tuse(ON_CPU["cuda"]):
        out = ttrain.train_loop(cfg, steps=12, batch=4, seq=32,
                                ckpt_dir=str(tmp_path), ckpt_every=4,
                                log_every=0, inject_failure_at=6)
        clean = ttrain.train_loop(cfg, steps=12, batch=4, seq=32,
                                  log_every=0)
    assert out["restarts"] == 1
    assert all(np.isfinite(l) for l in out["losses"])
    assert CheckpointManager(str(tmp_path)).latest() == 12
    assert len(out["losses"]) == 12
    np.testing.assert_allclose(out["losses"], clean["losses"], rtol=1e-6)


def test_train_loop_resume_from_checkpoint(tmp_path):
    cfg = tget_config("qwen2-1.5b", reduced=True)
    with tuse(ON_CPU["torch"]):
        ttrain.train_loop(cfg, steps=6, batch=4, seq=32,
                          ckpt_dir=str(tmp_path), ckpt_every=3, log_every=0)
        out = ttrain.train_loop(cfg, steps=10, batch=4, seq=32,
                                ckpt_dir=str(tmp_path), ckpt_every=5,
                                log_every=0)
    # resumed from step 6 → only 4 more losses
    assert len(out["losses"]) == 4
    assert CheckpointManager(str(tmp_path)).latest() == 10


def test_cli_trains_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ttrain.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--remat", "nothing", "--microbatches", "2"])
    out = buf.getvalue()
    assert rc == 0 and "[train] step     0 loss" in out
    assert "[train] done. loss" in out and "(restarts=0)" in out


def test_train_loop_runs_on_the_card_unless_asked():
    cfg = tget_config("qwen2-1.5b", reduced=True)
    if torch.cuda.is_available():
        pytest.skip("with a card the default device is there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.train_loop(cfg, steps=1, batch=2, seq=8, log_every=0)


def test_master_tree_converts_from_the_reference(models):
    """The reference's train state (master + AdamW moments) carries
    across leaf for leaf."""
    m = models
    hp = JOptConfig()
    jp = jax.tree_util.tree_map(jnp.asarray, m["host"])
    state = jax.device_get({"params": jp, "opt": jinit_opt(jp, hp)})
    got = from_numpy_tree(state, "cpu")
    want = tinit_opt(model_params_from_numpy(m["host"], m["tm"].cfg, "cpu"),
                     TOptConfig())
    assert sorted(got["opt"]) == sorted(want) == ["m", "step", "v"]
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(got["opt"]["m"]),
                                tree_leaves_with_path(want["m"])):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype
    assert got["opt"]["step"].dtype == want["step"].dtype == torch.int32
