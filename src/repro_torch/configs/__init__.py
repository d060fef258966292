"""Architecture registry: ``get_config(arch_id)`` -> ModelConfig.

The reference registers ten architectures; the port carries the configs of
the families it runs so far.  Asking for a registered but unported one
raises ``NotImplementedError`` naming the slice that brings it.
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

PORTED = ("gemma-2b", "mamba2-1.3b", "recurrentgemma-9b")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHITECTURES}


def get_config(arch: str, **overrides):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHITECTURES}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP queue 1: MoE / MLA / "
            f"encdec / vlm slice); ported: {list(PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.config()
    return cfg.with_(**overrides) if overrides else cfg

