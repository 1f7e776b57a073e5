"""The port's span recorder (``runtime/spans.py``) and the spans of the
training step (``launch/steps.py::make_train_step``), on the CPU.

Spans record only while a ``torch.profiler`` session is active; one step
records ``train.step`` with ``train.forward``, ``train.backward`` and
``train.optimizer`` nested in it; the spans share the profiler's clock,
so the forward's ops lie inside ``train.forward``; ``take()`` clears.
"""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.options import CompileOptions, use_options
from repro_torch.launch import steps
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import spans

PHASES = ["train.step", "train.forward", "train.backward", "train.optimizer"]


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


@pytest.fixture(scope="module")
def tiny():
    """(make_step(microbatches), state, batch) of the reduced qwen2 at
    2 × 8 tokens, f32 compute, no remat, on the CPU."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = build_model(cfg)
    opts = CompileOptions(target="cuda", device="cpu")

    def hp(k):
        return steps.TrainHParams(
            optimizer=OptimizerConfig(warmup_steps=0), remat_policy="none",
            compute_dtype="float32", microbatches=k)

    with use_options(opts):
        state = steps.init_train_state(model, hp(1), 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    seq = torch.randint(1, cfg.vocab_size, (2, 9), generator=gen)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def run(k=1):
        fn = steps.make_train_step(model, hp(k))
        with use_options(opts):
            return fn(state, batch)
    return run


def _profiled(run, k=1):
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(k)
    return spans.take(), prof


def test_a_step_without_a_profiler_records_nothing(tiny):
    spans.take()
    tiny()
    assert spans.take() == []
    assert spans.span("a") is spans.span("b")      # the shared null context


def test_a_profiled_step_records_its_phases_nested_in_order(tiny):
    got, _ = _profiled(tiny)
    assert [s.name for s in got] == PHASES
    step, *phases = got
    assert [s.parent for s in got] == [-1, 0, 0, 0]
    assert {s.thread for s in got} == {threading.get_ident()}
    assert all(s.start_ns <= s.end_ns for s in got)
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    assert all(step.start_ns <= s.start_ns and s.end_ns <= step.end_ns
               for s in phases)


def test_microbatches_repeat_forward_and_backward_under_one_step(tiny):
    got, _ = _profiled(tiny, 2)
    assert [s.name for s in got] == [
        "train.step", "train.forward", "train.backward", "train.forward",
        "train.backward", "train.optimizer"]
    assert [s.parent for s in got] == [-1, 0, 0, 0, 0, 0]


def test_the_profilers_ops_fall_inside_their_phase(tiny):
    """The spans and the profiler's host events share one clock: the
    forward's own ops lie inside ``train.forward``, the backward's
    inside ``train.backward``, and no op of the step straddles a phase's
    edge."""
    (step, fwd, bwd, opt), prof = _profiled(tiny)
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]

    def inside(op, s):
        return s.start_ns <= op[0] and op[1] <= s.end_ns

    for name, phase in (("aten::embedding", fwd), ("aten::logsumexp", fwd),
                        ("aten::embedding_dense_backward", bwd)):
        hits = [op for op in ops if op[2] == name]
        assert hits and all(inside(op, phase) for op in hits), name
    in_step = [op for op in ops if inside(op, step)]
    assert sum(inside(op, fwd) for op in in_step) > 10
    assert sum(inside(op, opt) for op in in_step) > 10
    for op in in_step:
        crosses = [s.name for s in (fwd, bwd, opt)
                   if op[0] < s.start_ns < op[1] or op[0] < s.end_ns < op[1]]
        assert not crosses, (op, crosses)


def test_take_returns_the_spans_and_clears_them(tiny):
    got, _ = _profiled(tiny)
    assert len(got) == 4
    assert spans.take() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            with spans.span("inner"):
                pass
    first = spans.take()
    assert [(s.name, s.parent) for s in first] == [("outer", -1),
                                                   ("inner", 0)]
    assert spans.take() == []
