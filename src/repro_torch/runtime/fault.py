"""Fault-tolerance runtime: straggler detection, preemption handling, and
a restore-and-retry supervisor for the training loop — the reference's
``runtime/fault.py`` (pure Python), copied.

At 1000+ nodes the failure model is: (a) slow hosts (network, thermal,
co-tenancy) — detect via per-step timing watermarks and surface to the
scheduler; (b) preemption (spot/maintenance) — SIGTERM arrives, we
checkpoint and exit 0 so the scheduler restarts us; (c) hard crashes —
the Retrier restores from the last atomic checkpoint.  All three compose
with CheckpointManager's atomic-rename guarantees.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class StragglerDetector:
    """EMA watermark over per-step wall time; flags steps slower than
    ``threshold`` × EMA.  On a real pod each host reports its own timing
    and the controller aggregates; here the single-process version keeps
    the same interface."""

    def __init__(self, threshold: float = 2.0, ema: float = 0.9,
                 warmup_steps: int = 3):
        self.threshold = threshold
        self.ema_factor = ema
        self.warmup_steps = warmup_steps
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: list = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> Optional[float]:
        """Returns the step's slowdown factor if flagged, else None."""
        dt = time.monotonic() - self._t0
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return None
        flagged = None
        if self.n > self.warmup_steps and dt > self.threshold * self.ema:
            flagged = dt / self.ema
            self.flagged.append((step, dt, self.ema))
        # EMA excludes flagged outliers so a straggler doesn't poison the
        # watermark
        if flagged is None:
            self.ema = self.ema_factor * self.ema + \
                (1 - self.ema_factor) * dt
        return flagged


class PreemptionHandler:
    """Installs a SIGTERM handler setting a flag the train loop polls;
    the loop checkpoints and exits cleanly inside one step boundary."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_term)
            except ValueError:          # not on main thread (tests)
                pass

    def _on_term(self, signum, frame):
        self.requested = True

    def uninstall(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


class Retrier:
    """Supervises a step function: on exception, invoke ``on_failure``
    (restore from checkpoint) and retry, up to ``max_retries`` per step."""

    def __init__(self, max_retries: int = 2):
        self.max_retries = max_retries
        self.failures: list = []

    def run(self, fn: Callable, on_failure: Callable, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except KeyboardInterrupt:
                raise
            except Exception as e:      # noqa: BLE001 — node failure model
                attempt += 1
                self.failures.append(repr(e))
                if attempt > self.max_retries:
                    raise
                on_failure(e, attempt)
