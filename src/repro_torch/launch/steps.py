"""Step-function builders shared by train / serve.

The port of ``repro.launch.steps``: closures for the three step kinds
and their input structures, per (arch config x shape). No device
allocation happens here — the state, batch and cache structures are
``meta`` tensors, which hold shapes and dtypes and no memory (the
reference's ``jax.eval_shape``).

The train step differentiates ``model.train_loss`` with autograd
(:func:`loss_and_grads`, the reference's ``jax.value_and_grad``) and
applies AdamW, which updates the state in place (the reference's jitted
step donates it). The reference's ``build_step`` adds shardings over a
device mesh; it waits for the port's distribution slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training/prefill inputs of one global batch, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend in ("audio", "vlm"):
        return {"input_embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                "labels": _meta((b, s), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32)}


def state_struct(cfg: ModelConfig) -> Dict[str, Any]:
    """``{"params", "opt"}`` of `cfg` as meta tensors: what a training
    checkpoint holds and is restored into."""
    params = convert.param_struct(cfg)

    def moment(p):
        return _meta(p.shape, torch.float32)

    return {"params": params,
            "opt": {"m": tree_lib.map_leaves(moment, params),
                    "v": tree_lib.map_leaves(moment, params),
                    "step": _meta((), torch.int32)}}


def cache_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return model_lib.init_decode_cache(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict
                   ) -> Tuple[torch.Tensor, dict, dict]:
    """``jax.value_and_grad(train_loss, has_aux=True)``: (loss, metrics,
    grads), the loss and metrics detached, the grads a tree of the
    parameters' shape and dtypes (zeros where a leaf is unused). Marks
    every parameter as requiring grad."""
    flat = tree_lib.flatten(params)
    for _, p in flat:
        p.requires_grad_(True)
    loss, metrics = model_lib.train_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in flat],
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for (_, p), g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_lib.unflatten(
        (path, g) for (path, _), g in zip(flat, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    def train_step(state, batch):
        loss, metrics, grads = loss_and_grads(cfg, state["params"], batch)
        new_params, new_opt, info = adamw.apply(
            opt_cfg, grads, state["opt"], state["params"])
        metrics = dict(metrics, loss=loss, **info)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, tokens, cache):
        return model_lib.decode_step(params, cfg, tokens, cache)
    return serve_step
