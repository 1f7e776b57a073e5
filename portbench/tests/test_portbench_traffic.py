"""The seeded inputs: the same seed gives the same weights, batches and
inputs, another seed other ones."""
import types
from pathlib import Path

import pytest
import torch

from portbench import harness, weights
from portbench.tests.small import CELLS

PB = Path(__file__).resolve().parents[1]
SEED = 2**31 + 99          # above 32 signed bits, as the driver's are


def _ctx(cell: str, seed: int):
    ctx = types.SimpleNamespace(seed=seed, device="cpu", torch=torch)
    body = CELLS[cell]
    w = harness.cell_entry(harness.benchmark(), cell)
    ctx.traffic = dict(harness.load_json(
        PB / "traffic" / f"{w['traffic']}.json"), **body["traffic"])
    ctx.config = dict(harness.load_json(
        PB / "configs" / f"{w['config']}.json"), **body["config"])
    return ctx


def test_weights_repeat_by_seed():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    spec = build_model(get_config("qwen2-1.5b", reduced=True)).spec
    a = weights.tree(spec, SEED, torch.bfloat16, "cpu")
    b = weights.tree(spec, SEED, torch.bfloat16, "cpu")
    c = weights.tree(spec, SEED + 1, torch.bfloat16, "cpu")
    la, lb, lc = (dict(harness_leaves(t)) for t in (a, b, c))
    assert la.keys() == lb.keys()
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["layers/mlp/w_up"], lc["layers/mlp/w_up"])
    norm = la["layers/ln1/scale"].float()
    assert abs(float(norm.mean()) - 1.0) < 0.1 and float(norm.std()) > 0.03


def harness_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from harness_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_training_batches_repeat_and_rows_differ():
    from portbench.entries import train_step as ent
    ctx = _ctx("qwen2-1.5b.train-8x512", SEED)
    t1, l1 = ent.batch(ctx, 1)
    t1b, l1b = ent.batch(ctx, 1)
    t2, _ = ent.batch(ctx, 2)
    assert torch.equal(t1, t1b) and torch.equal(l1, l1b)
    assert not torch.equal(t1, t2)
    assert torch.equal(t1[:, 1:], l1[:, :-1])
    assert len({tuple(r.tolist()) for r in t1}) == t1.shape[0]
    assert int(t1.min()) >= 1 and int(t1.max()) < ctx.config["vocab_size"]


@pytest.mark.parametrize("cell", ["qwen2-1.5b.mlp-compile-t4096",
                                  "qwen2-1.5b.mlp-auto-t4096"])
def test_compiled_call_inputs_repeat(cell):
    from portbench.entries import compiled_call as ent
    ctx = _ctx(cell, SEED)
    _, (x1,), p1 = ent.build(ctx)
    _, (x2,), p2 = ent.build(ctx)
    _, (x3,), _ = ent.build(_ctx(cell, SEED + 1))
    assert torch.equal(x1, x2) and torch.equal(p1["w_down"], p2["w_down"])
    assert x1.shape == (ctx.traffic["rows"], ctx.config["hidden_size"])
    assert not torch.equal(x1, x3)

