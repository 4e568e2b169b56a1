"""Mixture-of-Experts layer with the paper's two dispatch strategies.

The port of ``repro.models.moe``, where expert routing is the
"divergence" of an LM workload and the dispatch strategy is the
granularity/coalescing choice of the warp-size study:

* ``lw_plus`` — padded-dense dispatch (large-warp analogue): tokens are
  scattered into fixed-capacity per-expert buffers ``(E, C, D)``; pad
  slots and dropped tokens are the masked-lane waste.
* ``sw_plus`` — sort-compact dispatch (small warps with ideal
  coalescing): tokens are sorted by expert, gathered into expert-
  contiguous, block-aligned rows by K3 (``kernels.ops.coalesced_gather``)
  and multiplied by K4 (``kernels.ops.moe_gmm``), three times a layer.

Both compute the same function (up to capacity drops); the tests hold
each against the dense oracle and against the reference. Semantics kept
from JAX: a stable sort, ``searchsorted(side="right")``, top-k with equal
values ordered by lower index first, indices clamped where JAX clamps.
Scatter-adds (``index_add_``, ``index_put_(accumulate=True)``) use
atomics on the card, in an order that changes from run to run, so
results there are compared with a tolerance.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig

NEG_INF = -1.0e9


def moe_init(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.moe_experts_eff
    p = {
        "router": init.dense((d, e), d, torch.float32),
        "w1": init.dense((e, d, f), d, dtype),
        "w3": init.dense((e, d, f), d, dtype),
        "w2": init.dense((e, f, d), f, dtype),
    }
    if cfg.moe_shared:
        p["shared"] = mlp_mod.mlp_init(init, cfg, dtype,
                                       d_ff=cfg.moe_shared * f)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` as int64 by comparison: no atomics, and no check
    of the ids that would wait on the device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values ordered by lower index first."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def router_probs(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> top-k (weights (T,k), experts (T,k)), aux loss scalar."""
    logits = torch.matmul(x.float(), params["router"])
    # Pad experts never win routing.
    pad = torch.arange(cfg.moe_experts_eff, device=x.device) >= \
        cfg.moe_experts
    logits = torch.where(pad[None, :], torch.tensor(
        NEG_INF, dtype=logits.dtype, device=x.device), logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = _top_k(probs, cfg.moe_top_k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)   # renormalize
    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    e = cfg.moe_experts_eff
    assign = _one_hot(idx[:, 0], e).float()
    frac = assign.mean(0)
    mean_p = probs.mean(0)
    aux = e * torch.sum(frac * mean_p)
    return w, idx, aux


# ---------------------------------------------------------------------------
# LW+ dispatch: padded-dense, fixed capacity
# ---------------------------------------------------------------------------


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
            / max(cfg.moe_experts, 1))
    return max(8, (c + 7) // 8 * 8)


def dispatch_lw_plus(params: dict, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (y (T, D), aux)."""
    t, d = x.shape
    e = cfg.moe_experts_eff
    k = cfg.moe_top_k
    w, idx, aux = router_probs(params, x, cfg)

    cap = capacity(cfg, t)
    flat_e = idx.reshape(-1)                                 # (T*k,)
    onehot = _one_hot(flat_e, e)                             # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1                    # position in expert
    pos = torch.sum(pos * onehot, dim=-1)                    # (T*k,)
    keep = pos < cap                                         # drop overflow
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    xk = x[:, None, :].expand(t, k, d).reshape(-1, d)
    contrib = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    expert_in = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    expert_in.index_put_((flat_e, pos_c), contrib, accumulate=True)

    h = torch.einsum("ecd,edf->ecf", expert_in, params["w1"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", expert_in, params["w3"])
    out = torch.einsum("ecf,efd->ecd", h, params["w2"])

    gathered = out[flat_e, pos_c]                            # (T*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    y = torch.sum(gathered.reshape(t, k, d) * w[..., None].to(x.dtype),
                  dim=1)
    return y, aux


# ---------------------------------------------------------------------------
# SW+ dispatch: sort-compact + grouped matmul (K3, K4)
# ---------------------------------------------------------------------------


def sort_by_expert(idx: torch.Tensor, n_experts: int, block: int):
    """Token-expert assignments -> BM-aligned compact layout.

    idx: (T, k) expert ids. Returns (all in *sorted assignment* space):
      order        (T*k,) int64   assignment index of each sorted slot
      dest         (T*k,) int64   padded-layout row of each sorted slot
      block_expert (T_pad/BM,) int32  expert owning each row-block
      t_pad        padded row count (a Python int from the shapes alone,
                   an upper bound, so nothing waits on the device)

    Each expert's group is padded to a multiple of `block`, so every
    row-block belongs to exactly one expert; trailing blocks past the
    last group are given to expert ``n_experts - 1``.
    """
    tk = idx.numel()
    dev = idx.device
    flat_e = idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]                                 # nondecreasing
    sizes = _one_hot(flat_e, n_experts).sum(0)               # bincount
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    starts = torch.cat([zero, torch.cumsum(sizes, 0)[:-1]])
    padded = (sizes + block - 1) // block * block
    ends = torch.cumsum(padded, 0)
    grp_start = torch.cat([zero, ends[:-1]])
    rank = torch.arange(tk, device=dev) - starts[sorted_e]
    dest = grp_start[sorted_e] + rank
    t_pad = tk + n_experts * (block - 1)                     # upper bound
    t_pad = (t_pad + block - 1) // block * block
    row_block = torch.arange(t_pad // block, device=dev) * block
    block_expert = torch.searchsorted(ends, row_block, right=True)
    block_expert = torch.clamp_max(block_expert, n_experts - 1)
    return order, dest, block_expert.to(torch.int32), t_pad


def dispatch_sw_plus(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-compact dispatch. x: (T, D) -> (y (T, D), aux).

    Launches K3 once and K4 three times (w1, w3, w2).
    """
    t, d = x.shape
    e = cfg.moe_experts_eff
    k = cfg.moe_top_k
    w, idx, aux = router_probs(params, x, cfg)

    order, dest, block_expert, t_pad = sort_by_expert(idx, e, block)
    token_src = order // k                                   # source rows
    # Dynamic coalescing: gather token rows into expert-contiguous layout.
    x_sorted = kernel_ops.coalesced_gather(x, token_src, dest, t_pad,
                                           block=block)

    h1 = kernel_ops.moe_gmm(x_sorted, params["w1"], block_expert, block)
    h3 = kernel_ops.moe_gmm(x_sorted, params["w3"], block_expert, block)
    h = F.silu(h1) * h3
    out = kernel_ops.moe_gmm(h, params["w2"], block_expert, block)

    flat_w = w.reshape(-1).to(x.dtype)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, token_src, out[dest] * flat_w[order][:, None])
    return y, aux


# ---------------------------------------------------------------------------
# Dense oracle (tests) + layer entry point
# ---------------------------------------------------------------------------


def dispatch_dense_oracle(params: dict, x: torch.Tensor, cfg: ModelConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, combined by router weights (no drops)."""
    w, idx, aux = router_probs(params, x, cfg)
    h = torch.einsum("td,edf->tef", x, params["w1"])
    h = F.silu(h) * torch.einsum("td,edf->tef", x, params["w3"])
    all_out = torch.einsum("tef,efd->ted", h, params["w2"])  # (T, E, D)
    sel = torch.gather(all_out, 1, idx[..., None].expand(
        -1, -1, all_out.shape[-1]))                          # (T, k, D)
    y = torch.sum(sel * w[..., None].to(x.dtype), dim=1)
    return y, aux


def moe_layer(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux. Routed experts + shared experts."""
    b, s, d = x.shape
    flat = x.reshape(-1, d)
    if cfg.moe_dispatch == "sw_plus_ep":
        raise NotImplementedError(
            "moe_dispatch 'sw_plus_ep' needs core/granularity.py, which the "
            "port does not have yet")
    if cfg.moe_dispatch == "sw_plus":
        y, aux = dispatch_sw_plus(params, flat, cfg)
    else:
        y, aux = dispatch_lw_plus(params, flat, cfg)
    y = y.reshape(b, s, d)
    if cfg.moe_shared:
        y = y + mlp_mod.mlp(params["shared"], x, cfg)
    return y, aux
