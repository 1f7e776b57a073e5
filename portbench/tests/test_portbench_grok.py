"""grok-1-314b's decode cell on the CPU at a small size: a sound run
comes out correct and the fp8 control does not; each fault the cell
guards against, planted under the timed path, comes out not correct (the
logit cap left out of decode, the post-norms left out, half the slots
never computed); a configuration that is not the published model is
refused before any work; the traced run reports the counted metric, and
the span metrics read a hand-built trace.

The configuration is cut to small widths, with a logit cap of 1 in
place of 30: the draws give scores of unit spread, which a cap of 30
moves by about 1e-3, so only a small cap shows whether decode applies
it.  The limits here are set, as the cell's own are on the card,
between the readings of sound runs and of the fp8 control, but from
runs at this size on the CPU (12 seeds): sound runs read at most 0.0123
(mean) and 0.0248 (worst row), the control at least 0.0666 and
0.0739."""
import contextlib
import dataclasses
import types
from unittest import mock

import pytest

from portbench import harness
from portbench.devtrace import Trace

CELL = "grok-1-314b.decode-512x1k"
SEED = 2**31 + 2026
GROK = {
    "emb_size": 64, "widening_factor": 3, "key_size": 16, "num_q_heads": 4,
    "num_kv_heads": 2, "num_layers": 2, "num_experts": 4, "vocab_size": 512,
    "attn_output_multiplier": 0.25, "attn_logit_cap": 1.0,
    "port": {"arch": "grok-1-314b",
             "fields": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                        "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
                        "head_dim": 16, "n_experts": 4,
                        "experts_per_tok": 2, "attn_logit_softcap": 1.0}}}
SMALL = {"config": GROK,
         "traffic": {"slots": 6, "context_min": 20, "context_spread": 5,
                     "block_size": 4, "prefill_slots": 2,
                     "sampled_slots": 4, "warmup_steps": 1},
         "limits": {"logit_gap": 0.035, "logit_gap_max": 0.05,
                    "route_tie_delta": 0.01}}
SPANS = ["experts_ms.decode", "dispatch_ms.decode", "attention_ms.decode",
         "experts_roofline.decode", "decode_attention_roofline.decode"]


@contextlib.contextmanager
def _no_cap():
    """Decode attention with the logit cap dropped."""
    from repro_torch.kernels import ops as kops
    real = kops.decode_attention

    def uncapped(*args, logit_softcap=None, **kw):
        return real(*args, **kw)
    with mock.patch.object(kops, "decode_attention", uncapped):
        yield


@contextlib.contextmanager
def _no_post_norms():
    """Every layer body without its post-norms (serving paths)."""
    from repro_torch.models import serve as serve_mod
    real = serve_mod.decoder_layer

    def body(lp, x, cfg, attend):
        return real(lp, x, dataclasses.replace(cfg, post_norms=False),
                    attend)
    with mock.patch.object(serve_mod, "decoder_layer", body):
        yield


@contextlib.contextmanager
def _half_slots():
    """A decode step that computes the first half of the slots and
    repeats their logits for the second half."""
    from repro_torch.models import serve as serve_mod
    real = serve_mod.paged_decode_step

    def step(params, token, cache, table, lengths, cfg, *, block_size):
        h = token.shape[0] // 2
        y, new = real(params, token[:h], cache, table[:h], lengths[:h],
                      cfg, block_size=block_size)
        return y.repeat(2, 1)[:token.shape[0]], new
    with mock.patch.object(serve_mod, "paged_decode_step", step):
        yield


FAULTS = {"cap_dropped_in_decode": _no_cap,
          "post_norms_dropped": _no_post_norms, "half_the_slots": _half_slots}


def _run(plant=contextlib.nullcontext, trace=False, overrides=SMALL):
    with plant():
        return harness.run_cell(CELL, SEED, 0.2, trace, device="cpu",
                                overrides=overrides, control=True)


def test_sound_run_is_correct_and_the_control_is_not():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"logit_gap", "logit_gap_max"}
    low = r["counters"]["control"]
    assert any(v > r["checks"][k]["limit"] for k, v in low.items()), low
    assert set(r["metrics"]) == {"call_ms", "setup_s"}
    assert r["counters"]["sampled_slots"][0] == 0
    assert r["counters"]["sampled_slots"][-1] == 5


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_caught(fault):
    r = _run(FAULTS[fault])
    assert not r["correct"], (fault, r["checks"])


def test_a_model_that_is_not_the_published_one_is_refused():
    """The parent's grok-1 (no post-norms, its own head, renormalised
    gates) fails before any work."""
    from repro_torch.configs import grok_1_314b
    cfg = dict(SMALL)
    with mock.patch.dict(grok_1_314b.PUBLISHED, post_norms=False,
                         tie_embeddings=False):
        with pytest.raises(ValueError, match="post_norms"):
            _run(overrides=cfg)


def test_traced_run_reports_the_counted_metric():
    r = _run(trace=True)
    assert r["correct"] and "breakdown" in r
    _, layer = harness.cell_metrics(harness.benchmark(), CELL)
    names = {m["name"] for m in layer}
    assert set(SPANS) | {"expert_rows.decode", "idle_pct.decode"} == names
    # the CPU has no device trace: the span metrics stay silent; the
    # counters give 2 groups x 4 experts x 128 slots over 6 tokens x 2
    assert not set(SPANS) & set(r["metrics"])
    assert r["metrics"]["expert_rows.decode"]["value"] == \
        pytest.approx(2 * 4 * 128 / 12)


MS = 1_000_000


def test_span_readers_on_a_hand_built_trace(monkeypatch):
    """Kernels (start, end, launch, name) in ms under the decode step's
    spans; the attention kernel is the only one ``kinds.attention``
    takes."""
    from repro_torch.runtime import spans
    from repro_torch.runtime.spans import Span
    ks = [(0, 2, 0.5, "index_put"), (3, 10, 2.5, "nvjet_tst_gemm"),
          (11, 12, 10.5, "gather"), (13, 16, 12.5, "page_gather"),
          (17, 19, 16.5, "decode_attention_bf16_kernel")]
    device = [(s * MS, e * MS, n, i) for i, (s, e, _, n) in enumerate(ks)]
    launches = {i: (t * MS, 1) for i, (_, _, t, _) in enumerate(ks)}
    trace = Trace(device, [], launches, 1.0, None)
    monkeypatch.setattr(spans, "take", lambda: [
        Span("moe.route", 0, 1 * MS), Span("moe.experts", 2 * MS, 3 * MS),
        Span("moe.combine", 10 * MS, 11 * MS),
        Span("attn.decode", 12 * MS, 17 * MS)])
    peak = harness.load_json(harness.PB / "peaks.json")[
        "NVIDIA H100 80GB HBM3"]
    run = types.SimpleNamespace(
        trace=trace, window_s=1.0, peak=peak,
        data={"steps": 2, "dtype": "bfloat16", "expert_flops": 1e12,
              "expert_bytes": 2 * 3.35e12 * 7e-3,
              "attention_bytes": 3.35e12 * 2e-3})
    got = {m: harness.load_module(harness.reader_path(m)).read(run)
           for m in SPANS}
    assert got["experts_ms.decode"] == pytest.approx(3.5)
    assert got["dispatch_ms.decode"] == pytest.approx(1.5)
    assert got["attention_ms.decode"] == pytest.approx(2.5)
    # 14 ms of bytes (over 1.0 ms of FLOPs) a step over 3.5 ms of kernels
    assert got["experts_roofline.decode"] == pytest.approx(400.0)
    # 2 ms of bytes over 1 ms a step of the attention kernel
    assert got["decode_attention_roofline.decode"] == pytest.approx(200.0)


def test_the_cells_files_agree():
    cfg = harness.load_json(harness.PB / "configs" / "grok-1-314b.json")
    fl = harness.load_module(harness.PB / "flops" / "grok-1-314b.py")
    tr = harness.load_json(harness.PB / "traffic" / "decode-512x1k.json")
    f = cfg["port"]["fields"]
    assert (f["n_layers"], f["d_model"], f["n_heads"], f["n_kv_heads"],
            f["d_ff"], f["vocab_size"], f["head_dim"], f["n_experts"],
            f["experts_per_tok"]) == (
        cfg["num_layers"], cfg["emb_size"], cfg["num_q_heads"],
        cfg["num_kv_heads"], fl.ffn_size(cfg), cfg["vocab_size"],
        cfg["key_size"], cfg["num_experts"], cfg["num_selected_experts"])
    assert cfg["attn_output_multiplier"] == pytest.approx(
        cfg["key_size"] ** -0.5)
    flops, held = fl.expert_products(cfg, tr)
    assert flops == 2 * 3 * 6144 * 32768 * 2 * 512 * 4
    assert held == pytest.approx(38.65e9, rel=1e-3)
    lens = [1020 + i % 129 for i in range(512)]
    assert fl.decode_attention_bytes(cfg, tr) == 4 * sum(
        4 * (n + 1) * 1024 + 4 * 6144 for n in lens)
    # each expert sees 128 routed tokens a step, as at 512 in flight
    assert tr["slots"] * cfg["num_selected_experts"] \
        // cfg["num_experts"] == 128
