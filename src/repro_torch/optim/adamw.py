"""Native AdamW with global-norm clipping and warmup-cosine schedule.

The port of ``repro.optim.adamw``, over the port's nested-dict trees.
Moments are fp32 regardless of parameter dtype; parameter updates are
computed in fp32 and cast back (bf16 rounds to nearest even, as
``astype`` does). The reference's arithmetic is kept op for op: the
schedule on float32 tensors, the global norm summed over the leaves in
JAX's order (``repro_torch.tree``), ``step`` an int32 scalar, the same
decay mask. Each operation rounds once, so no multiply-add is fused
where the reference's expression has two roundings.

:func:`apply` updates the parameters and the optimizer state in place
(the reference's train step donates its state, so XLA reuses the
buffers) and returns them, with the reference's return value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: dict) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_lib.leaves(params)[0].device)
    return {"m": tree_lib.map_leaves(zeros, params),
            "v": tree_lib.map_leaves(zeros, params),
            "step": step}


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_lib.leaves(tree)))


def _decay_mask(path) -> bool:
    """Apply weight decay only to matrices (not norms/biases/scalars)."""
    return path[-1] not in ("attn_norm", "mlp_norm", "ssm_norm",
                            "final_norm", "norm", "q_norm", "k_norm",
                            "A_log", "D", "dt_bias", "conv_x_b", "conv_bc_b")


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: dict, opt: dict, params: dict,
          grad_norm: Optional[torch.Tensor] = None
          ) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_opt, info): `params` and `opt`, updated in
    place. `grads` has the parameters' tree (any float dtype). Where the
    trees hold a rank's shards, `grad_norm` gives the global norm of the
    whole gradient (default: :func:`global_norm` of `grads`)."""
    opt["step"].add_(1)
    step = opt["step"]
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    # The four trees have one structure, so their leaves line up.
    for (path, p), g, m, v in zip(tree_lib.flatten(params),
                                  tree_lib.leaves(grads),
                                  tree_lib.leaves(opt["m"]),
                                  tree_lib.leaves(opt["v"])):
        wd = cfg.weight_decay if _decay_mask(path) else 0.0
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        denom = torch.sqrt(v / b2c).add_(cfg.eps)
        step_val = (m / b1c).div_(denom)
        del denom
        pf = p.float()
        step_val.add_(wd * pf)
        p.copy_(pf.sub_(lr * step_val))
    info = {"grad_norm": gnorm, "lr": lr}
    return params, opt, info
