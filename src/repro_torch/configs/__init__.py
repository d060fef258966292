"""Architecture registry: ``get_config(arch_id)`` -> ModelConfig.

One module per architecture the reference registers; every config cites its
source.  Input shapes (train_4k / prefill_32k / decode_32k / long_500k)
live in shapes.py.
"""

from __future__ import annotations

import importlib

ARCHITECTURES = [
    "grok-1-314b",
    "command-r-plus-104b",
    "mamba2-1.3b",
    "yi-9b",
    "recurrentgemma-9b",
    "whisper-medium",
    "phi-3-vision-4.2b",
    "llama3-8b",
    "gemma-2b",
    "deepseek-v2-236b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHITECTURES}


def get_config(arch: str, **overrides):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHITECTURES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.config()
    return cfg.with_(**overrides) if overrides else cfg


def list_architectures() -> list[str]:
    return list(ARCHITECTURES)
