"""Step-function builders shared by train / serve.

The port of ``repro.launch.steps``: closures for the three step kinds
and their input structures, per (arch config x shape x mesh). No device
allocation happens here — the state, batch and cache structures are
``meta`` tensors, which hold shapes and dtypes and no memory (the
reference's ``jax.eval_shape``).

The train step differentiates ``model.train_loss`` with autograd
(:func:`loss_and_grads`, the reference's ``jax.value_and_grad``) and
applies AdamW, which updates the state in place (the reference's jitted
step donates it).

:func:`build_step` adds a device mesh, as the reference's does with
GSPMD shardings, and threads ``sharding.make_sharder``'s callback
through the model, as the reference does. The state is stored as
DTensors in the reference's layouts (``sharding.param_specs``): each
rank holds its shard of every parameter and AdamW moment, and a step
computes with those shards. Under ``tp`` (and ``swep``) each rank
computes its own "model" shard of every layer, with Megatron's
collectives inside the layer; FSDP shards over the data axes are
gathered one layer at a time (under ``tp`` and ``fsdp``), inside the
layer's checkpointed body, and their gradients reduce-scattered back
(``models.model``). The ranks of the "model" axis hold one loss
between them; each rank's loss is its share of the global mean over
every other axis (its cross-entropy sum over the token count of those
axes' ranks), so the gradients are summed over them: a TP-sharded or
FSDP-gathered gradient leaves its gather already reduce-scattered over
the data axes, and a parameter's shard is all-reduced over the other
axes it is replicated on, never over "model" (a parameter every "model"
rank holds gets the same gradient on each: those used inside a rank's
shard enter through Megatron's "copy"). AdamW updates the local shards,
and the gradient norm is global. On a mesh of one rank every collective
is skipped, and the step is the plain step's operations.

A MoE layer of the ``lw_plus`` or ``sw_plus`` dispatch routes the global
batch, as the reference's GSPMD step does: each mesh step runs within
``granularity.global_routing`` over its data axes, so the layer sums its
router statistics over the data ranks and places LW+'s assignments by
the counts of the ranks before it (``models.moe``). With one data rank
no collective runs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import sharding
from repro_torch import tree as tree_lib
from repro_torch.core import granularity
from repro_torch.launch import mesh as mesh_lib
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


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                   sharder=None, **share) -> Tuple[torch.Tensor, dict, dict]:
    """``jax.value_and_grad(train_loss, has_aux=True)``: (loss, metrics,
    grads), the loss and metrics detached, the grads a tree of the
    parameters' shape and dtypes (zeros where a leaf is unused). Marks
    every parameter as requiring grad. `sharder` and `share`
    (``tokens``, ``aux_weight``) go to ``model.train_loss``."""
    flat = tree_lib.flatten(params)
    for _, p in flat:
        p.requires_grad_(True)
    loss, metrics = model_lib.train_loss(
        params, cfg, batch, sharder or sharding.NO_SHARDER, **share)
    grads = torch.autograd.grad(loss, [p for _, p in flat],
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for (_, p), g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_lib.unflatten(
        (path, g) for (path, _), g in zip(flat, grads))


def accumulate(loss_grads, params: dict, batch: dict, accum: int
               ) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of one step over `accum` microbatches, from
    ``loss_grads(micro) -> (loss, metrics, grads)``. With `accum` > 1 the
    batch has the (accum, b_micro, ...) leading layout; the grads are
    summed in float32 and divided by `accum`, the loss is the mean, and
    the metrics are empty (the reference's microbatch scan)."""
    if accum == 1:
        return loss_grads(batch)
    grads = tree_lib.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32,
                       device=tree_lib.leaves(params)[0].device)
    for i in range(accum):
        micro = {k: v[i] for k, v in batch.items()}
        micro_loss, _, g = loss_grads(micro)
        for gsum, gi in zip(tree_lib.leaves(grads), tree_lib.leaves(g)):
            gsum.add_(gi.float())
        del g
        loss = loss + micro_loss
    for gsum in tree_lib.leaves(grads):
        gsum.div_(accum)
    return loss / accum, {}, grads


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


# ---------------------------------------------------------------------------
# Steps on a device mesh
# ---------------------------------------------------------------------------


def _local_params(params: dict) -> dict:
    """Each DTensor's local shard (the same storage), a leaf of its own
    for autograd."""
    return tree_lib.map_leaves(lambda p: p.to_local().detach(), params)


def _local_rows(batch: dict, mesh, dp, dim: int = 0) -> dict:
    """This rank's rows (its block over `dp` along `dim`) of each leaf of
    a global batch; views."""
    return {k: sharding.local_block(v, mesh, dp, dim)
            for k, v in batch.items()}


def _reduce_grad(g: torch.Tensor, p: DTensor, sh) -> torch.Tensor:
    """This rank's gradient share of `p`'s local shard, summed over the
    loss's axes (``sh.sum_axes``) that its FSDP gather has not summed
    over already: those `p` is replicated on."""
    axes = [a for a, pl in zip(p.device_mesh.mesh_dim_names, p.placements)
            if a in sh.sum_axes and not isinstance(pl, Shard)]
    return mesh_lib.all_reduce(g, p.device_mesh, axes)


def _global_norm(grads: list, placements: list, mesh) -> torch.Tensor:
    """``adamw.global_norm`` of the whole gradient from each rank's
    shards: a shard that several ranks hold (replicated over a mesh axis)
    counts once, on the rank at index 0 of that axis."""
    coord = mesh.get_coordinate()
    sq = []
    for g, pl in zip(grads, placements):
        s = torch.sum(torch.square(g.float()))
        if any(isinstance(p, Replicate) and c != 0
               for p, c in zip(pl, coord)):
            s = torch.zeros_like(s)
        sq.append(s)
    total = mesh_lib.all_reduce(torch.stack(sq), mesh, "all")
    return torch.sqrt(sum(total.unbind(0)))


def mesh_loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                        mesh, dp, accum: int = 1, layout: str = "tp"):
    """The global loss and this rank's gradient shards of one step on
    `mesh` in `layout` (see the module's docstring): (loss, metrics,
    grads), the loss and metrics global (the same on every rank), the
    grads a list of the local shards of the parameters' DTensors, in
    ``tree.flatten`` order. `batch` is the global batch (every rank
    passes the same; with `accum` > 1 in the (accum, b_micro, ...)
    layout, its rows split on dim 1)."""
    dim = 1 if accum > 1 else 0
    sh = sharding.make_sharder(mesh, dp, layout).bind(
        params, rows=next(iter(batch.values())).shape[dim])
    local = _local_params(params)
    rows = _local_rows(batch, mesh, dp, dim)

    def loss_grads(micro):
        with granularity.global_routing(sh.mesh, sh.dp):
            return loss_and_grads(cfg, local, micro, sh, **_share(micro, sh))

    loss, metrics, grads = accumulate(loss_grads, local, rows, accum)
    loss, metrics = _global_metrics(loss, metrics, sh)
    shards = [_reduce_grad(g, p, sh) for p, g in
              zip(tree_lib.leaves(params), tree_lib.leaves(grads))]
    return loss, metrics, shards


def _share(micro: dict, sh) -> dict:
    """``train_loss``'s arguments that make a rank's loss its share of
    the global mean: the token count of the loss's axes' ranks and
    1/their number of the balance term."""
    count = (micro["labels"] >= 0).sum().float()
    return {"tokens": torch.clamp_min(
                mesh_lib.all_reduce(count, sh.mesh, sh.sum_axes), 1.0),
            "aux_weight": 1.0 / mesh_lib.axis_size(sh.mesh, sh.sum_axes)}


def _global_metrics(loss, metrics: dict, sh):
    """The global loss and metrics from each rank's share."""
    mesh, axes = sh.mesh, sh.sum_axes
    n = mesh_lib.axis_size(mesh, axes)
    loss = mesh_lib.all_reduce(loss.clone(), mesh, axes)
    if metrics:
        replicas = n // mesh_lib.axis_size(mesh, sh.dp)   # ranks a row is on
        metrics = {"ce": mesh_lib.all_reduce(metrics["ce"], mesh, axes),
                   "aux": mesh_lib.all_reduce(metrics["aux"], mesh,
                                              axes) / n,
                   "tokens": metrics["tokens"] / replicas}
    return loss, metrics


@torch.no_grad()
def mesh_loss(cfg: ModelConfig, params: dict, batch: dict, mesh, dp,
              layout: str = "tp"):
    """The global loss and metrics of :func:`mesh_loss_and_grads` without
    gradients: what a config whose layers have no backward (``sw_plus``,
    on K3 and K4) can compute on `mesh`."""
    sh = sharding.make_sharder(mesh, dp, layout).bind(
        params, rows=next(iter(batch.values())).shape[0])
    local = _local_rows(batch, mesh, dp)
    with granularity.global_routing(sh.mesh, sh.dp):
        loss, metrics = model_lib.train_loss(
            _local_params(params), cfg, local, sh, **_share(local, sh))
    return _global_metrics(loss, metrics, sh)


def make_mesh_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                         mesh, dp, accum: int = 1, layout: str = "tp"):
    """The train step on `mesh`, over `accum` microbatches.
    ``step_fn(state, batch)`` takes the state as DTensors and the global
    batch (:func:`mesh_loss_and_grads`), updates the state in place and
    returns it with ``{"loss", "grad_norm", "lr"}`` (plus ``"ce"``,
    ``"aux"``, ``"tokens"`` when `accum` is 1): global values, the same
    on every rank."""

    def step_fn(state, batch):
        loss, metrics, shards = mesh_loss_and_grads(
            cfg, state["params"], batch, mesh, dp, accum, layout)
        flat = tree_lib.flatten(state["params"])
        gnorm = _global_norm(shards, [p.placements for _, p in flat], mesh)
        local_state = tree_lib.map_leaves(lambda t: t.to_local(), state)
        grads = tree_lib.unflatten(
            (path, g) for (path, _), g in zip(flat, shards))
        _, _, info = adamw.apply(opt_cfg, grads, local_state["opt"],
                                 local_state["params"], grad_norm=gnorm)
        return state, {"loss": loss, **info, **metrics}

    return step_fn


def _done(sh) -> tuple:
    """The mesh axes a step's outputs are already this rank's block over:
    the data axes, and the tensor-parallel one."""
    return sharding._axes(sh.dp) + ((sh.tp_axis,) if sh.tp_axis else ())


def make_mesh_prefill_step(cfg: ModelConfig, max_len: int, mesh, dp,
                           logits_spec, cache_spec, layout: str = "tp"):
    """Prefill on `mesh`: the rank's shards, this rank's rows of the
    global batch; returns the logits and the cache as DTensors with
    `logits_spec` / the cache's specs."""
    base = sharding.make_sharder(mesh, dp, layout)

    @torch.no_grad()
    def prefill_step(params, batch):
        sh = base.bind(params, rows=next(iter(batch.values())).shape[0])
        with granularity.global_routing(sh.mesh, sh.dp):
            logits, cache = model_lib.prefill(
                _local_params(params), cfg, _local_rows(batch, mesh, dp),
                max_len, sh)
        return (sharding.shard_local(logits, mesh, logits_spec,
                                     done=_done(sh)),
                _shard_cache(cache, mesh, cache_spec, _done(sh)))
    return prefill_step


def make_mesh_serve_step(cfg: ModelConfig, mesh, dp, logits_spec,
                         cache_spec, layout: str = "tp"):
    """One decode step on `mesh`: the global tokens, the cache as
    DTensors with its specs (its local shards are the rank's heads and
    channels under ``tp``); returns the logits and the cache as
    DTensors."""
    base = sharding.make_sharder(mesh, dp, layout)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        sh = base.bind(params, rows=tokens.shape[0])
        local_cache = tree_lib.map_leaves(
            lambda t: sharding.gather(t, keep=_done(sh))
            if isinstance(t, DTensor) else t, cache)
        with granularity.global_routing(sh.mesh, sh.dp):
            logits, local_cache = model_lib.decode_step(
                _local_params(params), cfg,
                sharding.local_block(tokens, mesh, dp, 0), local_cache, sh)
        return (sharding.shard_local(logits, mesh, logits_spec,
                                     done=_done(sh)),
                _shard_cache(local_cache, mesh, cache_spec, _done(sh)))
    return serve_step


def _shard_cache(cache: dict, mesh, specs: dict, done) -> dict:
    return tree_lib.map_leaves(
        lambda t, s: sharding.shard_local(t, mesh, s, done=done)
        if isinstance(t, torch.Tensor) else t, cache, specs)


def _layout_dp(mesh, global_batch: int, layout: str):
    if layout == "fsdp":
        # both axes act as data parallel when the batch divides them
        dp_all = tuple(a for a in ("pod", "data", "model")
                       if a in mesh.mesh_dim_names)
        if global_batch % mesh_lib.axis_size(mesh, dp_all) == 0:
            return dp_all
    return sharding.data_axes(mesh, global_batch)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               opt_cfg: adamw.AdamWConfig | None = None,
               layout: str = "tp", accum: int = 1):
    """Returns (fn, example_args, in_placements, out_placements).

    layout: "tp" (Megatron TP x FSDP) | "fsdp" (pure ZeRO-3) |
            "swep" (TP with the expert-parallel SW+ MoE dispatch).
    `example_args` are ``meta`` tensors (no allocation); the placements
    are trees of DTensor placement tuples on `mesh`
    (``sharding.to_placements``). The train step takes `accum`
    microbatches (its batch then has the (accum, b_micro, S) layout).
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if layout == "swep":
        cfg = dataclasses.replace(cfg, moe_dispatch="sw_plus_ep")
    dp = _layout_dp(mesh, shape.global_batch, layout)
    sharder = sharding.make_sharder(mesh, dp, layout)
    granularity.set_mesh(sharder.mesh, sharder.dp)
    P = sharding.PartitionSpec

    if shape.kind == "train":
        st = state_struct(cfg)
        bt = batch_struct(cfg, shape)
        bspec = sharding.batch_specs(bt, dp)
        if accum > 1:
            bt = {k: _meta((accum, v.shape[0] // accum) + tuple(v.shape[1:]),
                           v.dtype) for k, v in bt.items()}
            bspec = {k: P(None, *s) for k, s in bspec.items()}
        in_pl = (sharding.to_placements(
                     mesh, sharding.state_specs(st["params"], layout)),
                 sharding.to_placements(mesh, bspec))
        metric_keys = ("loss", "grad_norm", "lr") + (
            ("ce", "aux", "tokens") if accum == 1 else ())
        replicated = (Replicate(),) * mesh.ndim
        out_pl = (in_pl[0], {k: replicated for k in metric_keys})
        fn = make_mesh_train_step(cfg, opt_cfg, mesh, dp, accum, layout)
        return fn, (st, bt), in_pl, out_pl

    params = state_struct(cfg)["params"]
    p_pl = sharding.to_placements(mesh, sharding.param_specs(params, layout))
    logits_spec = P(dp, None) if layout == "fsdp" else P(dp, "model")
    logits_pl = sharding.to_placements(mesh, logits_spec)
    cache = cache_struct(cfg, shape)
    cspec = sharding.cache_specs(cache, dp)
    cache_pl = sharding.to_placements(mesh, cspec)

    if shape.kind == "prefill":
        bt = {k: v for k, v in batch_struct(cfg, shape).items()
              if k != "labels"}
        in_pl = (p_pl, sharding.to_placements(
            mesh, sharding.batch_specs(bt, dp)))
        fn = make_mesh_prefill_step(cfg, shape.seq_len, mesh, dp,
                                    logits_spec, cspec, layout)
        return fn, (params, bt), in_pl, (logits_pl, cache_pl)

    # decode: one new token with a seq_len-deep cache
    if cfg.frontend in ("audio", "vlm"):
        tok = _meta((shape.global_batch, 1, cfg.d_model), torch.bfloat16)
        tok_pl = sharding.to_placements(mesh, P(dp, None, None))
    else:
        tok = _meta((shape.global_batch, 1), torch.int32)
        tok_pl = sharding.to_placements(mesh, P(dp, None))
    fn = make_mesh_serve_step(cfg, mesh, dp, logits_spec, cspec, layout)
    return fn, (params, tok, cache), (p_pl, tok_pl, cache_pl), (logits_pl,
                                                                cache_pl)
