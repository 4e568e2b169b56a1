"""Dense MLP: SwiGLU (llama-family) or GELU.

Under tensor parallelism (a ``sharder`` with ``tp`` > 1) the weights are
a rank's shards: ``w1``/``w3`` column-parallel (its d_ff columns),
``w2`` row-parallel (its d_ff rows); the input enters through Megatron's
"copy" and the output leaves through its "reduce"."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding
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


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
        sharder=None) -> torch.Tensor:
    """x: (..., D) -> (..., D)."""
    sh = sharder or sharding.NO_SHARDER
    x = sh.copy(x)
    h = torch.matmul(x, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.matmul(x, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return sh.reduce(torch.matmul(h, params["w2"]))
