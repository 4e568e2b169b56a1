"""Architecture registry: --arch <id> -> ModelConfig (full or smoke)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_ARCHS: Dict[str, str] = {
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-3-8b": "granite_3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-8b": "qwen3_8b",
    "mistral-large-123b": "mistral_large_123b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "hymba-1.5b": "hymba_1_5b",
}

# Archs with a sub-quadratic long-context mode (run long_500k); the pure
# full-attention archs skip it.
LONG_CONTEXT_ARCHS = ("mamba2-780m", "hymba-1.5b")


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.CONFIG
    return cfg.validate()


def runnable_shapes(arch: str) -> List[str]:
    """Shape cells for this arch (long_500k only for sub-quadratic archs)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes
