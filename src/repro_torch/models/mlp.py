"""Dense MLP: SwiGLU (llama-family) or GELU."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig


def mlp_init(init: Init, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w1": init.dense((d, ff), d, dtype),
        "w2": init.dense((ff, d), ff, dtype),
    }
    if cfg.act == "swiglu":
        p["w3"] = init.dense((d, ff), d, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., D) -> (..., D)."""
    h = torch.matmul(x, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.matmul(x, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.matmul(h, params["w2"])
