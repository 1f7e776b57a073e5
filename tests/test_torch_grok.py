"""The port's grok-1-314b, the published model, held to the plain
reference of the benchmark (``portbench/reference/grok-1-314b.py``,
loaded by path) on the CPU, reduced, at f32 compute, with every
published part on: the logit cap in every attention path, the norms
after attention and after the MoE, the embedding and output
multipliers, the tied head, RMSNorm's ε of 1e-5, the top-2 gates as the
softmax gave them and no token dropped.

The weights are the benchmark's seeded draws (``portbench/weights.py``:
norm scales 1 + N(0, 0.1²)), the query projection times 10, so that the
largest scaled scores reach the cap of 30 and the cap does work (the
draws alone give scores of unit spread, which the cap moves by about
1e-3).

* ``forward_train``'s logits, the contiguous prefill and decode, the
  paged decode over two slots of different lengths and the paged
  chunked prefill, each within 1e-5 of the largest entry of the
  reference's forward at the same positions;
* for each part, the port with that part switched off misses the
  reference by more than 1e-2 of its largest entry: the cap in decode
  (the decode-attention call without it), the post-norms, each
  multiplier, the tied head (a head of its own); the renormalised gates
  at the MoE's output (the model's post-norm divides out a factor common
  to a token's gates, so past it only ε could tell them apart); and
  under a router skewed so that 301 tokens of one group all choose one
  expert (past its capacity of 256), the MoE equals the reference's,
  which drops nothing, and misses it with drops.
"""
import contextlib
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:        # the reference imports portbench's
    sys.path.insert(0, str(ROOT))    # plain layers

from portbench import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.options import CompileOptions, use_options  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import serve as serve_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


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


def _load_reference():
    path = ROOT / "portbench" / "reference" / "grok-1-314b.py"
    spec = importlib.util.spec_from_file_location("grok_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()
# the benchmark's configuration at the reduced config's widths
CFG = dict(json.loads((ROOT / "portbench" / "configs" /
                       "grok-1-314b.json").read_text()),
           emb_size=64, widening_factor=3, key_size=16, num_q_heads=4,
           num_kv_heads=2, num_layers=2, num_experts=4, vocab_size=512,
           attn_output_multiplier=0.25)
SEED = 2**31 + 33
B, S = 2, 12
QUERY_SCALE = 10.0
ON_CPU = CompileOptions(target="cuda", device="cpu")


def _cfg(**kw):
    return dataclasses.replace(get_config("grok-1-314b", reduced=True),
                               compute_dtype="float32", **kw)


def _near(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(),
                               err_msg=str(what))


def _misses(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() > 1e-2 * np.abs(want).max()


@pytest.fixture(scope="module")
def grok():
    model = build_model(_cfg())
    params = weights.tree(model.spec, SEED, torch.float32, "cpu")
    params["layers"]["attn"]["wq"].mul_(QUERY_SCALE)
    seq = weights.tokens(weights.generator(SEED + 1, "cpu"), (B, S), 512,
                         "cpu")
    ref = torch.stack([REF.logits(params, seq[b], CFG) for b in range(B)])
    return model, params, seq, ref


def test_the_configs_are_the_published_model():
    cfg = get_config("grok-1-314b")
    assert (cfg.embed_scale, cfg.logit_scale) == (
        CFG["embedding_multiplier_scale"], CFG["output_multiplier_scale"])
    assert (cfg.norm_eps, cfg.attn_logit_softcap) == (1e-5, 30.0)
    assert cfg.post_norms and cfg.tie_embeddings and cfg.moe_dropless
    assert not cfg.moe_renormalize
    spec = build_model(cfg).spec
    assert "head" not in spec
    assert {"ln1", "ln1_post", "ln2", "ln2_post"} <= set(spec["layers"])


def test_forward_train_matches_the_reference(grok):
    model, params, seq, ref = grok
    with use_options(ON_CPU):
        got = model.forward(params, {"tokens": seq})[0]
    for b in range(B):
        _near(got[b].detach(), ref[b], 1e-5, b)


def _contiguous(model, params, seq, P=5):
    """Prefill of P tokens, then decode to the end: logits at positions
    P - 1 .. S - 1."""
    with use_options(ON_CPU):
        last, cache = model.prefill(params, {"tokens": seq[:, :P]},
                                    max_len=S)
        out = [last]
        for t in range(P, S):
            y, cache = model.decode_step(params, seq[:, t].int(), cache, t)
            out.append(y)
    return torch.stack(out, 1), P - 1


def _paged(model, params, seq, prompts=(5, 8), bs=4):
    """Each slot's prompt prefilled and scattered into the paged pools,
    then the paged decode step over both slots to the end: logits at
    positions (prompt - 1 .. S - 1) per slot."""
    per_slot = -(-S // bs)
    table = 1 + torch.arange(B * per_slot, dtype=torch.int32).view(
        B, per_slot)
    out = [[] for _ in range(B)]
    with use_options(ON_CPU):
        pools = model.init_paged_cache(B * per_slot + 1, bs, device="cpu")
        for b, P in enumerate(prompts):
            last, cache = model.prefill(params, {"tokens": seq[b:b + 1, :P]},
                                        max_len=P)
            out[b].append(last[0])
            pools = serve_mod.scatter_prefill_paged(
                pools, cache["kv"], table[b, :-(-P // bs)].tolist(), bs)
        lengths = torch.tensor(prompts, dtype=torch.int32)
        while int(lengths.min()) < S:
            pos = lengths.clamp(max=S - 1)
            y, pools = model.paged_decode_step(
                params, seq[torch.arange(B), pos.long()].int(), pools, table,
                pos, block_size=bs)
            for b in range(B):
                if int(lengths[b]) < S:
                    out[b].append(y[b])
            lengths = lengths + 1
    return [torch.stack(o) for o in out], [P - 1 for P in prompts]


def _chunked(model, params, seq, bs=4):
    """Slot 0's prompt through the paged chunked prefill, a block a
    chunk: the logits at each chunk's last position."""
    table = torch.arange(1, 1 + -(-S // bs), dtype=torch.int32)
    out = []
    with use_options(ON_CPU):
        pools = model.init_paged_cache(len(table) + 1, bs, device="cpu")
        for start in range(0, S, bs):
            y, pools = model.paged_prefill_chunk(
                params, seq[0, start:start + bs].int(), start, pools, table,
                block_size=bs)
            out.append(y)
    return torch.stack(out), list(range(bs - 1, S, bs))


@pytest.mark.parametrize("path", ["contiguous", "paged", "chunked"])
def test_serving_paths_match_the_reference_forward(grok, path):
    model, params, seq, ref = grok
    if path == "contiguous":
        got, first = _contiguous(model, params, seq)
        for b in range(B):
            _near(got[b], ref[b, first:], 1e-5, b)
    elif path == "paged":
        got, firsts = _paged(model, params, seq)
        for b in range(B):
            _near(got[b], ref[b, firsts[b]:], 1e-5, b)
    else:
        got, at = _chunked(model, params, seq)
        _near(got, ref[0, at], 1e-5, "chunks")


@contextlib.contextmanager
def _decode_uncapped():
    real = kops.decode_attention

    def uncapped(*args, logit_softcap=None, **kw):
        return real(*args, **kw)
    with mock.patch.object(kops, "decode_attention", uncapped):
        yield


PARTS = ("cap_in_decode", "post_norms", "embed_scale", "logit_scale",
         "tied_head", "unrenormalised_gates")


@pytest.mark.parametrize("part", PARTS)
def test_each_part_switched_off_misses_the_reference(grok, part):
    model, params, seq, ref = grok
    if part == "cap_in_decode":
        with _decode_uncapped():
            got, firsts = _paged(model, params, seq)
        assert _misses(got[0], ref[0, firsts[0]:])
        return
    if part == "unrenormalised_gates":
        cfg, p, x = _moe_inputs(skewed=False)
        want = _reference_moe(cfg, p, x)
        got = moe_mod.apply_moe(p, x, cfg)[0][0]
        _near(got, want, 1e-5, "published")
        got = moe_mod.apply_moe(p, x, dataclasses.replace(
            cfg, moe_renormalize=True))[0][0]
        assert _misses(got, want)
        return
    off = {"post_norms": {"post_norms": False},
           "embed_scale": {"embed_scale": 1.0},
           "logit_scale": {"logit_scale": 1.0},
           "tied_head": {"tie_embeddings": False}}[part]
    other = build_model(_cfg(**off))
    p = dict(params)
    if part == "tied_head":
        p["head"] = weights.tree({"head": other.spec["head"]}, SEED + 2,
                                 torch.float32, "cpu")["head"]
    with use_options(ON_CPU):
        got = other.forward(p, {"tokens": seq})[0].detach()
    assert _misses(got, ref)


def _moe_inputs(skewed: bool):
    """The MoE's parameters and one group of 301 tokens; ``skewed``:
    every token's first choice is expert 0 (input feature 0 meets a
    router row that lifts expert 0 and lowers the rest), more than its
    256 slots."""
    cfg = _cfg()
    p = weights.tree(moe_mod.moe_spec(cfg), SEED + 3, torch.float32, "cpu")
    g = weights.generator(SEED + 4, "cpu")
    x = torch.randn((1, 301, cfg.d_model), generator=g)
    if skewed:
        x[..., 0] = 4.0
        p["router"][0, :] = -2.0
        p["router"][0, 0] = 2.0
    return cfg, p, x


def _reference_moe(cfg, p, x):
    """The reference's MoE of the one group: every token through its
    top-k experts, gated by their probabilities."""
    h = x[0]
    probs, order = REF.route(h, p["router"])
    idx = order[:, :cfg.experts_per_tok]
    return REF.experts(h, idx, torch.gather(probs, 1, idx),
                       {n: w[None] for n, w in p.items()}, 0)


@pytest.mark.parametrize("dropless", [True, False])
def test_dropless_routing_under_a_skewed_router(dropless):
    cfg, p, x = _moe_inputs(skewed=True)
    assert moe_mod.capacity(301, cfg) == 256
    assert int((REF.route(x[0], p["router"])[1][:, 0] == 0).sum()) == 301
    want = _reference_moe(cfg, p, x)
    got = moe_mod.apply_moe(p, x, dataclasses.replace(
        cfg, moe_dropless=dropless))[0][0]
    if dropless:
        _near(got, want, 1e-5, "dropless")
    else:
        assert _misses(got, want)
