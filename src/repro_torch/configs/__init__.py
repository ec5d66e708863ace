"""Assigned architecture configs (``--arch <id>``).

Each module exports ``CONFIG`` (the exact public config) and ``SMOKE``
(reduced same-family config for CPU smoke tests).  ``get_config(name)``
resolves either.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "smollm_360m",
    "qwen15_05b",
    "qwen2_05b",
    "stablelm_16b",
    "phi35_moe",
    "arctic_480b",
    "whisper_base",
    "llava_next_mistral_7b",
    "jamba_15_large",
    "xlstm_125m",
]

ALIASES = {
    "smollm-360m": "smollm_360m",
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen2-0.5b": "qwen2_05b",
    "stablelm-1.6b": "stablelm_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "arctic-480b": "arctic_480b",
    "whisper-base": "whisper_base",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "xlstm-125m": "xlstm_125m",
}


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCHS}
