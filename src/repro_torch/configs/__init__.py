"""Architecture configs — one module per architecture, copied from the
reference's ``configs`` package.

``get_config(name)`` returns the exact published config;
``get_config(name, reduced=True)`` returns the same-family smoke-test
variant (small widths/layers/experts, tiny vocab) used by tests on CPU.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen2_1_5b",
    "starcoder2_15b",
    "qwen1_5_32b",
    "qwen3_32b",
    "rwkv6_3b",
    "grok_1_314b",
    "arctic_480b",
    "whisper_base",
    "qwen2_vl_2b",
    "recurrentgemma_9b",
)

# CLI ids (assignment spelling) → module names
ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen3-32b": "qwen3_32b",
    "rwkv6-3b": "rwkv6_3b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "whisper-base": "whisper_base",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.reduced_config() if reduced else mod.config()


def all_arch_ids() -> list:
    return sorted(ALIASES)
