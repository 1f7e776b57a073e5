"""Deterministic synthetic LM data pipeline — the port of the reference's
``data/pipeline.py`` (numpy, so its batches are the reference's bit for
bit; only the DualView is the port's).

Properties a production pipeline needs and this one has:

* **Deterministic & stateless-resumable** — batch ``i`` is a pure function
  of (seed, i); checkpointing the pipeline = saving one integer.  Restart
  replays exactly.
* **Host-staged through DualViews** — batches are produced in numpy and
  mirrored to the device lazily; prefetch keeps ``prefetch`` batches in
  flight (the paper's memory model doing the input side of the training
  loop).
* **Learnable structure** — tokens follow a noisy affine recurrence, so
  "loss decreases over steps" is a meaningful integration test, unlike
  uniform noise.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.core.dualview import DualView


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05         # fraction of tokens replaced with noise


class SyntheticLMDataset:
    """``device``: where the batches' DualViews mirror to (the card unless
    the caller asks for the CPU)."""

    def __init__(self, cfg: DataConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = device

    def batch_np(self, index: int) -> dict:
        """Batch ``index`` as numpy (pure function of (seed, index))."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, index]))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        a = 31
        start = rng.integers(0, V, B, dtype=np.int64)
        steps = np.arange(S + 1, dtype=np.int64)[None, :]
        seq = (start[:, None] * pow(a, 1, V) + 7 * steps * steps +
               steps * start[:, None]) % V
        noise_mask = rng.random((B, S + 1)) < cfg.noise
        noise_tok = rng.integers(0, V, (B, S + 1))
        seq = np.where(noise_mask, noise_tok, seq)
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def batch_dualview(self, index: int) -> dict:
        return {k: DualView.from_host(v, name=f"batch{index}/{k}",
                                      device=self.device)
                for k, v in self.batch_np(index).items()}

    def iter_from(self, start_index: int, prefetch: int = 2
                  ) -> Iterator[dict]:
        """Background-threaded prefetching iterator starting at
        ``start_index`` (the checkpointed pipeline state)."""
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()

        def producer():
            i = start_index
            while not stop.is_set():
                q.put((i, self.batch_dualview(i)))
                i += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:                      # unblock the producer
                q.get_nowait()
            except queue.Empty:
                pass
