"""Each plain reference against the port at a small configuration on
the CPU, both in float32: the MLP block, qwen2's logits, its loss and
three AdamW steps."""
import dataclasses

import pytest
import torch

from portbench import harness, weights
from portbench.tests.small import QWEN

PB = harness.PB
QREF = harness.load_module(PB / "reference" / "qwen2-1.5b.py")
MREF = harness.load_module(PB / "reference" / "gated_mlp_block.py")
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    from repro_torch.core.options import CompileOptions, use_options
    with use_options(CompileOptions(device="cpu")):
        yield


def _cfg(name, small):
    return dict(harness.load_json(PB / "configs" / f"{name}.json"), **small)


def _port(name, small):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), **small["port"]["fields"],
                               compute_dtype="float32").validate()


def test_mlp_block_against_the_port():
    from repro_torch.core import pipeline
    from repro_torch.core.options import CompileOptions
    from repro_torch.models.mlp import gated_mlp_block
    cfg = _cfg("qwen2-1.5b", QWEN)
    g = weights.generator(SEED, "cpu")
    p = {"w_gate": torch.randn(64, 128, generator=g) / 8,
         "w_up": torch.randn(64, 128, generator=g) / 8,
         "w_down": torch.randn(128, 64, generator=g) / 11}
    x = torch.randn(24, 64, generator=g)
    mod = pipeline.compile(lambda xv: gated_mlp_block(p, xv, act="silu"), x,
                           options=CompileOptions(target="cuda",
                                                  device="cpu"))
    torch.testing.assert_close(mod(x), MREF.call((x,), p, cfg, {}),
                               rtol=1e-5, atol=1e-5)


def _qwen_setup():
    from repro_torch.models.model import build_model
    model = build_model(_port("qwen2-1.5b", QWEN))
    params = weights.tree(model.spec, SEED, torch.float32, "cpu")
    g = weights.generator(SEED + 1, "cpu")
    seq = weights.tokens(g, (2, 17), 512, "cpu")
    return model, params, seq[:, :-1], seq[:, 1:]


def test_qwen2_logits_against_the_port():
    from repro_torch.models.transformer import forward_train
    model, params, tokens, _ = _qwen_setup()
    port, _ = forward_train(params, {"tokens": tokens}, model.cfg)
    cfg = _cfg("qwen2-1.5b", QWEN)
    for b in range(tokens.shape[0]):
        torch.testing.assert_close(port[b], QREF.logits(params, tokens[b],
                                                        cfg),
                                   rtol=2e-4, atol=2e-4)


def test_qwen2_loss_against_the_port():
    model, params, tokens, labels = _qwen_setup()
    port = model.loss(params, {"tokens": tokens, "labels": labels})
    ref = QREF.loss(params, tokens, labels, _cfg("qwen2-1.5b", QWEN))
    assert float(port) == pytest.approx(float(ref), rel=2e-6)


def test_qwen2_adamw_steps_against_the_port():
    from repro_torch.launch import steps
    from repro_torch.models.spec import tree_leaves_with_path
    from repro_torch.optim import OptimizerConfig, init_opt_state
    model, params, _, _ = _qwen_setup()
    opt = harness.load_json(PB / "traffic" / "train-8x512.json")["optimizer"]
    hp = steps.TrainHParams(optimizer=OptimizerConfig(**opt),
                            remat_policy="none", compute_dtype="float32")
    g = weights.generator(SEED + 2, "cpu")
    batches = []
    for _ in range(3):
        seq = weights.tokens(g, (2, 17), 512, "cpu")
        batches.append((seq[:, :-1], seq[:, 1:]))
    state = {"params": params, "opt": init_opt_state(params, hp.optimizer)}
    step = steps.make_train_step(model, hp)
    losses = []
    for i, (t, lab) in enumerate(batches):
        state, m = step(state, {"tokens": t, "labels": lab})
        losses.append(float(m["loss"]))
        if i == 0:
            grad1 = {"/".join(p): float(v.norm()) / (1 - opt["b1"])
                     for p, v in tree_leaves_with_path(state["opt"]["m"])}
    params0 = weights.tree(model.spec, SEED, torch.float32, "cpu")
    ref = QREF.train_steps(params0, batches, _cfg("qwen2-1.5b", QWEN), opt)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert grad1 == pytest.approx(ref["grad1"], rel=1e-4, abs=1e-9)
    change = {"/".join(p): float((w - w0).norm()) for (p, w), (_, w0) in zip(
        tree_leaves_with_path(state["params"]),
        tree_leaves_with_path(params0))}
    moving = [k for k, v in ref["grad1"].items() if v > 1e-3 * max(
        ref["grad1"].values())]
    assert {k: change[k] for k in moving} == pytest.approx(
        {k: ref["change"][k] for k in moving}, rel=1e-3)
