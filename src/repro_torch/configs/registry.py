"""Architecture registry: --arch <id> -> ModelConfig (full or smoke).

The port covers the ``dense`` and ``moe`` families. ``mamba2-780m``
(``ssm``) and ``hymba-1.5b`` (``hybrid``) need ``models/ssm.py``, which
comes with a later slice of the port; asking for them raises
NotImplementedError.
"""

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

# Archs whose family needs models/ssm.py, which the port does not have yet.
NOT_PORTED = {"mamba2-780m": "ssm", "hymba-1.5b": "hybrid"}


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {list_archs()}")
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is a {NOT_PORTED[arch]!r} model: it needs "
            "models/ssm.py, which comes with the next slice of the port "
            "(the kernel_bench path with K5 and K6)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.CONFIG
    return cfg.validate()
