"""The join of the program's spans with the card's trace
(``portbench/progspans.py``) on hand-built traces, and the readers of
the training step's span metrics."""
import sys
import types

import pytest

from portbench import harness, progspans
from portbench.devtrace import Trace
from repro_torch.runtime.spans import Span

MS = 1_000_000
READERS = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "step_idle_ms.train"]


def _trace(kernels, window_s=1.0):
    """``kernels``: (start, end, launch time, launching thread), in ms."""
    device = [(s * MS, e * MS, f"k{i}", i)
              for i, (s, e, _, _) in enumerate(kernels)]
    launches = {i: (t * MS, tid) for i, (_, _, t, tid) in enumerate(kernels)}
    return Trace(device, [], launches, window_s, None)


def _spans(*spec):
    """(name, start, end) in ms, parents left out (the join reads times)."""
    return [Span(n, s * MS, e * MS) for n, s, e in spec]


STEP = _spans(("train.step", 0, 100), ("train.forward", 1, 30),
              ("train.backward", 31, 70), ("train.optimizer", 71, 99))


def test_a_kernel_launched_on_another_thread_counts_for_the_backward():
    tr = _trace([(10, 20, 5, 1), (40, 50, 35, 2), (80, 95, 75, 1)])
    j = progspans.join(tr, STEP)
    assert j.kernel_ns["train.backward"] == 10 * MS
    assert j.kernel_ns["train.forward"] == 10 * MS
    assert j.kernel_ns["train.optimizer"] == 15 * MS


def test_the_innermost_span_wins():
    tr = _trace([(2, 3, 0.5, 1), (5, 6, 2, 1), (40, 41, 30.5, 1),
                 (95, 99, 99.5, 1), (150, 151, 120, 1)])
    j = progspans.join(tr, STEP)
    assert j.kernel_ns["train.forward"] == 1 * MS
    assert j.kernel_ns["train.step"] == (1 + 1 + 4) * MS
    assert j.kernel_ns[progspans.OUTSIDE] == 1 * MS
    assert sum(j.kernel_ns.values()) == sum(e - s for s, e, _, _ in
                                            tr.kernels)


def test_a_gap_inside_train_step_is_the_steps_idle_and_one_outside_is_not():
    # gaps: 20-41 (midpoint 30.5, in train.step between forward and
    # backward: the step is innermost), 50-80 (65, in train.backward),
    # 95-120 (107.5, after the step)
    tr = _trace([(10, 20, 5, 1), (41, 50, 35, 1), (80, 95, 75, 1),
                 (120, 130, 101, 1)])
    j = progspans.join(tr, STEP)
    assert j.step_idle_ns == (21 + 30) * MS
    assert j.idle_ns["train.step"] == 21 * MS
    assert j.idle_ns["train.backward"] == 30 * MS
    assert j.idle_ns[progspans.OUTSIDE] == 25 * MS
    assert j.steps == 1


def test_spans_outside_the_window_are_dropped():
    old = _spans(("train.step", -500, -400), ("train.forward", -499, -450))
    tr = _trace([(10, 20, 5, 1), (40, 50, 35, 1)])
    j = progspans.join(tr, old + STEP)
    assert j.steps == 1
    assert progspans.join(tr, old) is None
    open_span = [Span("train.step", 1 * MS)]         # never closed
    assert progspans.join(tr, open_span) is None


def _view(trace, steps=1):
    return types.SimpleNamespace(trace=trace, data={"steps": steps},
                                 window_s=trace.window_s)


def _read(name, view):
    return harness.load_module(harness.reader_path(name)).read(view)


def test_readers_take_the_programs_spans_once_a_window(monkeypatch):
    from repro_torch.runtime import spans
    taken = []
    monkeypatch.setattr(spans, "take",
                        lambda: taken.append(1) or list(STEP))
    view = _view(_trace([(10, 20, 5, 1), (40, 50, 35, 2),
                         (80, 95, 75, 1)]), steps=2)
    got = {n: _read(n, view) for n in READERS}
    assert got == {"forward_ms.train": 5.0, "backward_ms.train": 5.0,
                   "optimizer_ms.train": 7.5, "step_idle_ms.train": 25.0}
    assert len(taken) == 1


@pytest.mark.parametrize("name", READERS)
def test_every_reader_returns_none_without_device_activity(name,
                                                           monkeypatch):
    from repro_torch.runtime import spans
    monkeypatch.setattr(spans, "take", lambda: list(STEP))
    assert _read(name, _view(Trace([], [], {}, 1.0, None))) is None


@pytest.mark.parametrize("name", READERS)
def test_every_reader_returns_none_for_a_program_without_spans(
        name, monkeypatch):
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert _read(name, _view(_trace([(10, 20, 5, 1)]))) is None


def test_a_traced_cpu_run_reads_no_span_metric_and_takes_the_spans():
    from repro_torch.runtime import spans

    from portbench.tests.small import CELLS
    cell = "qwen2-1.5b.train-8x512"
    spans.take()
    r = harness.run_cell(cell, 2**31 + 2026, 0.2, True, device="cpu",
                         overrides=CELLS[cell])
    assert r["correct"] and not set(READERS) & set(r["metrics"])
    assert spans.take() == []
