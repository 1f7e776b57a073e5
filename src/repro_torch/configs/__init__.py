"""Architecture configs — one module per architecture (the reference's
``configs`` package, copied as the model slices need them).

``get_config(name)`` returns the exact published config;
``get_config(name, reduced=True)`` returns the same-family smoke-test
variant (small widths/layers/experts, tiny vocab) used by tests on CPU.
"""
from __future__ import annotations

import importlib

# The configs ported so far; the others arrive with the model slices.
ARCHS = (
    "qwen2_1_5b",
    "rwkv6_3b",
    "recurrentgemma_9b",
)

# CLI ids (assignment spelling) → module names
ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.reduced_config() if reduced else mod.config()


def all_arch_ids() -> list:
    return sorted(ALIASES)
