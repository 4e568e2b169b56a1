"""The execution-granularity engine — the paper's SW+ design as a
distributed MoE dispatch.

The port of ``repro.core.granularity``. ``sw_plus_ep_layer`` is the
expert-parallel sort–compact dispatch:

* tokens are data-sharded and *replicated across the model axis*,
  experts are sharded over the model axis (EP);
* each model rank selects the assignments routed to *its* experts,
  sort-compacts them into BM-aligned groups (the dynamic-coalescing pass —
  small logical granularity, contiguous physical access), and runs the
  grouped matmul on exactly those rows;
* partial token outputs are combined with ONE sum over the model axis per
  layer — the MoE dispatch costs no all-to-all at all in this layout.

The reference runs the per-shard body under ``shard_map``; the port runs
it on each rank as explicit SPMD over ``torch.distributed``: a rank's own
token rows, its own ``E/tp`` experts, its model coordinate, then the
reductions over the mesh's process groups (``launch.mesh.psum`` /
``pmean``, which differentiate as the reference's do).

The grouped matmul is the block-gather formulation (one weight tile
gathered per BM row-block), as in the reference, which computes it
outside any Pallas kernel; it differentiates, so the ``swep`` layout
trains. K3 and K4 (``models.moe.dispatch_sw_plus``) have no backward.

:class:`DataRanks` and :func:`global_routing` give the other dispatches
(``lw_plus``, ``sw_plus``) the global batch's routing on a mesh: while a
mesh step runs, ``models.moe`` reads its data ranks here.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig

_MESH = None
_DP = None
_RANKS = None


def set_mesh(mesh, dp=None) -> None:
    """Install the mesh (and data axes) used by sw_plus_ep layers."""
    global _MESH, _DP
    _MESH = mesh
    _DP = dp


class DataRanks:
    """The data ranks of a mesh whose rows one MoE layer routes together,
    as the reference's GSPMD program routes its global batch: rank i of
    the ``n`` holds block i of the rows (``sharding.local_block``'s
    order, major axis first)."""

    def __init__(self, mesh, dp):
        self.mesh = mesh
        self.axes = sharding._axes(dp)
        self.index, self.n = sharding._coordinate(mesh, self.axes)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (differentiable)."""
        return mesh_lib.psum(t, self.mesh, self.axes)

    def before(self, counts: torch.Tensor) -> torch.Tensor:
        """The sum of `counts` over the ranks before this one in block
        order (an all-gather over each data axis, minor first)."""
        rows = counts[None]
        for a in reversed(self.axes):
            rows = mesh_lib.all_gather_stack(rows, self.mesh, a).reshape(
                -1, *counts.shape)
        return rows[:self.index].sum(0)


def data_ranks() -> Optional[DataRanks]:
    """The data ranks of the mesh step running now (None off a mesh, or
    with one data rank)."""
    return _RANKS


@contextlib.contextmanager
def global_routing(mesh, dp):
    """Within the block, MoE layers route over `dp`'s ranks of `mesh`
    (when there are more than one): ``launch.steps`` enters it around
    each step it runs on a mesh, backward and remat recompute included."""
    global _RANKS
    prev = _RANKS
    _RANKS = (DataRanks(mesh, dp)
              if dp and mesh_lib.axis_size(mesh, dp) > 1 else None)
    try:
        yield
    finally:
        _RANKS = prev


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def sw_plus_ep_layer(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     dp=None, block: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel SW+ dispatch on this rank.

    x: (B_loc, S, D), this rank's rows of the batch (its block over `dp`,
    the same on every rank of the model axis); params: the layer's router
    and all ``E`` experts, or this rank's own ``E / tp`` (each rank
    computes with its own). Returns (y (B_loc, S, D) this rank's rows,
    aux loss scalar), both the same on every rank of the model axis.
    """
    mesh = _MESH
    assert mesh is not None, "granularity.set_mesh(mesh) required for sw_plus_ep"
    if dp is None:
        dp = _DP
    tp = mesh_lib.axis_size(mesh, "model")
    m_idx = mesh.get_local_rank("model")
    e_eff = cfg.moe_experts_eff
    e_loc = e_eff // tp
    k = cfg.moe_top_k
    b, s, d = x.shape
    t_loc = b * s
    dev = x.device
    # Per-shard row budget: this shard's expected share of assignments,
    # with the capacity-factor slack, BM-aligned (+1 spill block).
    c_shard = _round_up(
        int(t_loc * k / tp * cfg.moe_capacity_factor) + block, block)
    mine = slice(m_idx * e_loc, (m_idx + 1) * e_loc)
    w1, w3, w2 = (params[n][mine] if params[n].shape[0] == e_eff
                  else params[n] for n in ("w1", "w3", "w2"))

    x_loc = x.reshape(t_loc, d)
    gates, idx, aux = moe_mod.router_probs(params, x_loc, cfg)
    owner = idx // e_loc                                   # (T_loc, k)
    local_e = torch.where(owner == m_idx, idx % e_loc,
                          torch.full_like(idx, e_loc))     # sentinel
    flat_e = local_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)             # mine first
    sorted_e = flat_e[order]
    sizes, padded = moe_mod._group_sizes(flat_e, e_loc + 1, block)
    zero = torch.zeros(1, dtype=sizes.dtype, device=dev)
    starts = torch.cat([zero, torch.cumsum(sizes, 0)[:-1]])
    grp_start = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    rank = torch.arange(flat_e.numel(), device=dev) - starts[sorted_e]
    dest = grp_start[sorted_e] + rank
    keep = (sorted_e < e_loc) & (dest < c_shard)          # mine & in budget

    token_src = order // k
    dest_c = torch.where(keep, dest, torch.full_like(dest, c_shard - 1))
    src_c = torch.where(keep, token_src, torch.zeros_like(token_src))
    # Dynamic coalescing: contiguous expert-sorted layout (C_shard, D).
    # (a sum, so dropped assignments' zero rows never clobber real rows)
    x_sorted = torch.zeros((c_shard, d), dtype=x.dtype, device=dev
                           ).index_add(0, dest_c, torch.where(
                               keep[:, None], x_loc[src_c],
                               torch.zeros((), dtype=x.dtype, device=dev)))

    nblk = c_shard // block
    row_block = torch.arange(nblk, device=dev) * block
    block_expert = torch.searchsorted(torch.cumsum(padded[:e_loc], 0),
                                      row_block, right=True)
    block_expert = torch.clamp_max(block_expert, e_loc - 1)

    # Block-gather grouped matmul (the plain form of kernels/moe_gmm).
    xb = x_sorted.reshape(nblk, block, d)
    h = torch.einsum("gbd,gdf->gbf", xb, w1[block_expert])
    h = F.silu(h) * torch.einsum("gbd,gdf->gbf", xb, w3[block_expert])
    out = torch.einsum("gbf,gfd->gbd", h, w2[block_expert])
    out = out.reshape(c_shard, d)

    gate_flat = gates.reshape(-1).to(x.dtype)[order]
    contrib = out[dest_c] * torch.where(
        keep, gate_flat, torch.zeros((), dtype=x.dtype, device=dev))[:, None]
    y = torch.zeros((t_loc, d), dtype=x.dtype, device=dev
                    ).index_add(0, src_c, contrib)
    # Combine expert contributions across the model axis (each token's
    # k experts live on <= k ranks): one sum per layer.
    y = mesh_lib.psum(y, mesh, "model")
    aux = mesh_lib.pmean(aux, mesh, "model")
    if dp:
        aux = mesh_lib.pmean(aux, mesh, dp)
    return y.reshape(b, s, d), aux


def sw_plus_ep_layer_tp(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        sharder) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sw_plus_ep_layer` in a model computed tensor-parallel over
    the model axis (``models.moe`` under the ``swep`` layout), where the
    model ranks hold one loss between them rather than a share each: the
    layer's gradients (psum semantics: each rank's is its share) come
    out partial, so its input and router enter through Megatron's
    "copy" and its outputs' gradients are split over the ranks."""
    if sharder.tp == 1:
        return sw_plus_ep_layer(params, x, cfg)
    params = dict(params, router=sharder.copy(params["router"]))
    y, aux = sw_plus_ep_layer(params, sharder.copy(x), cfg)
    return (sharder.scale_grad(y, 1.0 / sharder.tp),
            sharder.scale_grad(aux, 1.0 / sharder.tp))


# ---------------------------------------------------------------------------
# Sequence-sharded flash decoding (unpadded KV heads)
# ---------------------------------------------------------------------------


def seq_sharded_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor,
                                 cache_positions: torch.Tensor, pos,
                                 window: Optional[int] = None,
                                 mesh=None) -> torch.Tensor:
    """Flash-decoding attention with the KV cache sharded by *sequence*
    over the model axis.

    Instead of padding KV heads to the TP degree, the cache keeps its
    original heads and splits the sequence dim across model ranks. Each
    rank computes partial online-softmax statistics (m, l, acc) over its
    slice; the combine is three small all-reduces (MAX, then two SUMs of
    (B, H, hd)-sized tensors) over the model axis.

    q: (B, H, hd) one-token queries (real heads only), the same on every
    rank; cache_k/v: (B, Sc_loc, H, hd), this rank's slice of the
    sequence; cache_positions: (Sc_loc,) its positions (-1 = empty).
    Returns (B, H, hd), the same on every rank of the model axis.
    """
    mesh = mesh or _MESH
    assert mesh is not None
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bhd,bkhd->bhk", q.float() * scale, cache_k.float())
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        valid &= (pos - cache_positions) < window
    s = torch.where(valid[None, None, :], s,
                    torch.tensor(-2.0e38, dtype=s.dtype, device=s.device))
    m_i = s.amax(-1)                                      # (B, H)
    p = torch.exp(s - m_i[..., None])
    l_i = p.sum(-1)
    acc_i = torch.einsum("bhk,bkhd->bhd", p, cache_v.float())
    m = mesh_lib.all_reduce(m_i.clone(), mesh, "model", dist.ReduceOp.MAX)
    corr = torch.exp(m_i - m)
    l = mesh_lib.all_reduce(l_i * corr, mesh, "model")
    acc = mesh_lib.all_reduce(acc_i * corr[..., None], mesh, "model")
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
