"""Faults planted under a run's timed path, to show that the comparison
catches them: used by the tests on the CPU and by ``control.py`` on the
card.  Each patches the port for the time of a ``with`` block."""
from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = {
    "compiled_call": ("answer_altered", "half_batch"),
    "train_step": ("state_unchanged", "half_batch"),
}


class _Altered:
    """A compiled module whose every output has element (0, 0) off by 1
    (``answer_altered``), or whose second half of rows repeats the first
    (``half_batch``: half the rows never computed)."""

    def __init__(self, mod, kind: str):
        self._mod, self._kind = mod, kind

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def __call__(self, *args):
        y = self._mod(*args).clone()
        if self._kind == "answer_altered":
            y[0, 0] += 1
            return y
        half = y.shape[0] // 2
        y[half:2 * half] = y[:half]
        return y


@contextlib.contextmanager
def planted(entry: str, kind: str):
    if kind not in FAULTS[entry]:
        raise ValueError(f"no fault {kind!r} for {entry}")
    if entry == "compiled_call":
        from repro_torch.core import pipeline
        real = pipeline.compile
        with mock.patch.object(pipeline, "compile",
                               lambda *a, **k: _Altered(real(*a, **k), kind)):
            yield
    else:
        from repro_torch.launch import steps
        real = steps.make_train_step

        def make(model, hp):
            step = real(model, hp)

            def faulty(state, batch):
                if kind == "half_batch":
                    half = batch["tokens"].shape[0] // 2
                    return step(state, {k: v[:half] for k, v in
                                        batch.items()})
                return state, step(state, batch)[1]
            return faulty
        with mock.patch.object(steps, "make_train_step", make):
            yield
