"""Model facade: one object per architecture wiring spec → init →
forward / loss / prefill / decode — the port of the reference's
``models/model.py``, used by tests, ``launch/train.py``,
``launch/serve.py`` and ``launch/dryrun.py``."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import serve as serve_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.spec import (abstract_params, axes_tree,
                                     init_params, param_count)


@dataclasses.dataclass
class Model:
    cfg: Any
    spec: dict

    # -- params ---------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda", dtype=None):
        """Seeded parameters on ``device`` (torch's random bits, the
        reference's shapes, init kinds and tree paths), a stacked leaf
        drawn one layer at a time; with ``dtype`` the floating leaves are
        made in it, so the f32 tree is never held (``spec.init_params``)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(self.spec, gen, device, dtype=dtype)

    def abstract(self):
        """The parameter tree as meta-device tensors (shapes, dtypes)."""
        return abstract_params(self.spec)

    def axes(self):
        """The parameter tree's logical axes (``dist/sharding.py``)."""
        return axes_tree(self.spec)

    def n_params(self) -> int:
        return param_count(self.spec)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return self.n_params()
        E, k = cfg.n_experts, cfg.experts_per_tok
        expert_p = 3 * cfg.d_model * cfg.d_ff * E * cfg.n_layers
        return int(self.n_params() - expert_p + expert_p * k / E)

    # -- compute ---------------------------------------------------------------
    def forward(self, params, batch: dict, *, remat_policy: str = "none",
                scan_unroll: int = 1):
        return tfm.forward_train(params, batch, self.cfg,
                                 remat_policy=remat_policy,
                                 scan_unroll=scan_unroll)

    def loss(self, params, batch: dict, *, remat_policy: str = "none",
             aux_weight: float = 0.01, scan_unroll: int = 1
             ) -> torch.Tensor:
        logits, aux = self.forward(params, batch,
                                   remat_policy=remat_policy,
                                   scan_unroll=scan_unroll)
        return tfm.lm_loss(logits, batch["labels"]) + aux_weight * aux

    def init_cache(self, batch: int, max_len: int, *,
                   quantized: bool = False, device="cuda"):
        return serve_mod.init_cache(self.cfg, batch, max_len,
                                    quantized=quantized, device=device)

    def prefill(self, params, batch: dict, *, max_len: int,
                quantized: bool = False):
        return serve_mod.prefill(params, batch, self.cfg, max_len=max_len,
                                 quantized=quantized)

    def decode_step(self, params, token, cache, length: int):
        return serve_mod.decode_step(params, token, cache, length, self.cfg)

    def init_paged_cache(self, n_blocks: int, block_size: int, *,
                         quantized: bool = False, device="cuda"):
        return serve_mod.init_paged_cache(self.cfg, n_blocks, block_size,
                                          quantized=quantized, device=device)

    def paged_decode_step(self, params, token, cache, table, lengths, *,
                          block_size: int):
        return serve_mod.paged_decode_step(params, token, cache, table,
                                           lengths, self.cfg,
                                           block_size=block_size)

    def paged_prefill_chunk(self, params, tokens, start: int, cache,
                            table_row, *, block_size: int):
        return serve_mod.paged_prefill_chunk(params, tokens, start, cache,
                                             table_row, self.cfg,
                                             block_size=block_size)


def build_model(cfg) -> Model:
    cfg.validate()
    return Model(cfg=cfg, spec=tfm.model_spec(cfg))
