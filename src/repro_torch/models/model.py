"""LM assembly: embedding, layers, loss, logits, prefill, decode.

The port of ``repro.models.model``. Families:

  dense  : attn + MLP
  moe    : attn + MoE (paper-technique dispatch, see models/moe.py)
  ssm    : Mamba2 block only
  hybrid : parallel attn + SSM heads (Hymba), mean-fused, then MLP

Parameters keep the reference's names and its stacked ``(L, ...)`` layer
layout, so a tree of the reference's weights carries over leaf for leaf
(``models.convert``); ``lax.scan`` over that axis becomes a Python loop
over views of it.

``train_loss`` is differentiated by autograd. ``forward_hidden`` takes
the layers with one ``torch.unbind`` per stacked leaf, whose backward
stacks each leaf's gradient once (a ``v[i]`` per layer would back into a
zero ``(L, ...)`` tensor per layer), and applies the config's remat
policy per layer, as the reference's ``jax.checkpoint`` of its scan
body does: ``"none"``, ``"full"`` (keep the layer's inputs, recompute
the rest) or ``"dots"`` (also keep the outputs of the products without
batch dimensions, ``aten.mm``: every projection; recompute the rest,
the batched attention and expert products, ``aten.bmm``, included).

Everything runs on the device the parameters lie on. Decode updates the
cache it is given in place (the reference returns a new one), which
saves a copy of the whole cache each step; it returns the cache as well,
so callers read the same as in the reference.

As in the reference, a ``sharder(name, x)`` callback
(``sharding.make_sharder``) comes in from the launch layer, at the
reference's call points, and the no-op default leaves the plain
operations. On a mesh it carries the rank's place: the parameters are
then the rank's local shards, each layer's FSDP shards are gathered
inside the function the remat policy checkpoints (recomputed in the
backward, never saved, so a layer's gathered weights die with it), and
the layers compute their tensor-parallel shards (``attention``, ``mlp``,
``ssm``, ``moe``). The embedding and the head are vocab-parallel: each
rank looks up and scores its block of the vocabulary, and the
cross-entropy's log-sum-exp and target logit are sums over the ranks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import sharding
from repro_torch import tree as tree_lib
from repro_torch.models import attention, common, mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import init_cache
from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import init_ssm_cache

FAMILIES = ("dense", "moe", "ssm", "hybrid")
_ATTN = ("dense", "moe", "hybrid")
_SSM = ("ssm", "hybrid")
_noop_sharder = sharding.NO_SHARDER


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not one of {FAMILIES}")


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return common.torch_dtype(cfg.dtype)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device with its index (``cuda`` -> the current
    card, as tensors report it); raises RuntimeError for ``cuda`` when no
    card is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(init, cfg: ModelConfig) -> dict:
    """One layer's parameters; `init` is an :class:`~common.Init` (or any
    object with its ``dense``/``embed``/``ones`` methods)."""
    _check_family(cfg)
    dt = param_dtype(cfg)
    p: Dict[str, Any] = {}
    if cfg.family in _ATTN:
        p["attn_norm"] = init.ones((cfg.d_model,), dt)
        p["attn"] = attention.attn_init(init, cfg, dt)
    if cfg.family in _SSM:
        p["ssm_norm"] = init.ones((cfg.d_model,), dt)
        p["ssm"] = ssm_mod.ssm_init(init, cfg, dt)
    if cfg.family == "moe":
        p["mlp_norm"] = init.ones((cfg.d_model,), dt)
        p["moe"] = moe_mod.moe_init(init, cfg, dt)
    elif cfg.family in ("dense", "hybrid"):
        p["mlp_norm"] = init.ones((cfg.d_model,), dt)
        p["mlp"] = mlp_mod.mlp_init(init, cfg, dt)
    return p


def _stack_into(dst: dict, src: dict, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def _empty_stacked(src: dict, n: int) -> dict:
    return {k: _empty_stacked(v, n) if isinstance(v, dict)
            else torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                             device=v.device)
            for k, v in src.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from one ``torch.Generator`` seeded with `seed`,
    drawn on `device` one layer at a time into the stacked layout (the
    float32 draws of one tensor are the only temporaries)."""
    cfg.validate()
    _check_family(cfg)
    init = Init(seed, resolve_device(device))
    dt = param_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": init.embed((cfg.vocab_padded, cfg.d_model), dt)}
    first = init_layer(init, cfg)
    layers = _empty_stacked(first, cfg.n_layers)
    _stack_into(layers, first, 0)
    del first
    for i in range(1, cfg.n_layers):
        _stack_into(layers, init_layer(init, cfg), i)
    params["layers"] = layers
    params["final_norm"] = init.ones((cfg.d_model,), dt)
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_padded),
                                       cfg.d_model, dt)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Views of layer `i` of the stacked ``params["layers"]`` tree."""
    return unstack_layers(params)[i]


def unstack_layers(params: dict) -> List[dict]:
    """Every layer of the stacked ``params["layers"]`` tree, one dict of
    views per layer, from one ``torch.unbind`` per leaf."""
    split = tree_lib.map_leaves(lambda v: torch.unbind(v, 0),
                                params["layers"])
    n_layers = len(tree_lib.leaves(split)[0])
    return [tree_lib.map_leaves(lambda views: views[i], split)
            for i in range(n_layers)]


# ---------------------------------------------------------------------------
# Layer bodies (full sequence)
# ---------------------------------------------------------------------------


def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig, sharder=_noop_sharder):
    """The layer's MLP or MoE on the normed hidden; returns (y, aux)."""
    hn = common.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_layer(lp["moe"], hn, cfg, sharder)
    return mlp_mod.mlp(lp["mlp"], hn, cfg, sharder), None


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, sharder=_noop_sharder
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = x + ssm_mod.ssm_layer(
            lp["ssm"], common.rms_norm(x, lp["ssm_norm"], cfg.norm_eps), cfg,
            sharder=sharder)
        return sharder("hidden", x), aux
    h = common.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a = attention.attention(lp["attn"], h, positions, cfg, sharder=sharder)
    if cfg.family == "hybrid":
        hs = common.rms_norm(x, lp["ssm_norm"], cfg.norm_eps)
        s = ssm_mod.ssm_layer(lp["ssm"], hs, cfg, sharder=sharder)
        x = x + 0.5 * (a + s)            # parallel heads, mean-fused (Hymba)
    else:
        x = x + a
    x = sharder("hidden", x)
    y, a2 = _ffn(lp, x, cfg, sharder)
    return sharder("hidden", x + y), aux if a2 is None else a2


#: Products whose outputs ``"dots"`` keeps: 2-D matmuls, the counterpart
#: of JAX's dot_generals without batch dimensions.
_SAVED_BY_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return torch_checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _remat_wrap(fn, cfg: ModelConfig):
    """`fn` under the config's remat policy, when autograd records (any
    other policy than ``"full"`` and ``"dots"`` is ``"none"``, as in the
    reference)."""
    if cfg.remat not in ("full", "dots") or not torch.is_grad_enabled():
        return fn
    extra = {"context_fn": _save_dots} if cfg.remat == "dots" else {}

    def wrapped(*args):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           **extra)
    return wrapped


def forward_hidden(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, sharder=_noop_sharder
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded input (B,S,D) -> final hidden (B,S,D), summed aux loss.
    Each layer's FSDP shards are gathered inside the checkpointed body."""
    _check_family(cfg)

    def body(lp, x, positions):
        return _layer_fwd(sharder.layer(lp), x, positions, cfg, sharder)

    layer = _remat_wrap(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params):
        x, a = layer(lp, x, positions)
        aux = aux + a
    x = common.rms_norm(
        x, sharder.gather(params["final_norm"], ("final_norm",)), cfg.norm_eps)
    return x, aux


def _lookup(params: dict, cfg: ModelConfig, tokens: torch.Tensor, sharder
            ) -> torch.Tensor:
    """The embedding rows of `tokens`; vocab-parallel under tensor
    parallelism (each rank's rows of its block, summed over the ranks:
    exactly one rank's is not zero)."""
    table = sharder.gather(params["embed"], ("embed",))
    tokens = tokens.long()
    if sharder.tp == 1:
        return table[tokens]
    local = tokens - sharder.tp_first(cfg.vocab_padded)
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    return sharder.reduce(rows.masked_fill(~inside[..., None], 0))


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict,
                 sharder=_noop_sharder) -> torch.Tensor:
    """tokens (B,S) int or input_embeds (B,S,D) -> (B,S,D)."""
    if "input_embeds" in batch:
        x = batch["input_embeds"].to(param_dtype(cfg))
    else:
        x = _lookup(params, cfg, batch["tokens"], sharder)
    if cfg.pos_emb == "sinusoidal":
        s = x.shape[1]
        pe = common.sinusoidal_pos_emb(torch.arange(s, device=x.device),
                                       cfg.d_model)
        x = x + pe[None].to(x.dtype)
    return x


def logits_fn(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
              sharder=_noop_sharder) -> torch.Tensor:
    """(B,S,D) -> (B,S,V_pad) fp32, pad vocab masked to -1e9 (under
    tensor parallelism, the rank's block of the vocabulary)."""
    head = (sharder.gather(params["embed"], ("embed",)).t()
            if cfg.tie_embeddings
            else sharder.gather(params["lm_head"], ("lm_head",)))
    logits = torch.matmul(sharder.copy(hidden), head).float()
    first = sharder.tp_first(cfg.vocab_padded)
    pad = torch.arange(first, first + logits.shape[-1],
                       device=hidden.device) >= cfg.vocab_size
    return sharder("logits", logits.masked_fill(pad[None, None, :], -1e9))


def _nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
         sharder) -> torch.Tensor:
    """logsumexp(logits) - logits[label] over the vocabulary, from the
    rank's block of it under tensor parallelism (the max, the sum of
    exponentials and the target logit taken over the ranks)."""
    if sharder.tp == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return lse - ll
    m = sharder.amax(logits.detach().amax(-1))
    lse = m + torch.log(sharder.reduce(
        torch.exp(logits - m[..., None]).sum(-1)))
    local = labels - sharder.tp_first(cfg.vocab_padded)
    inside = (local >= 0) & (local < logits.shape[-1])
    ll = torch.gather(logits, -1, torch.where(
        inside, local, torch.zeros_like(local))[..., None])[..., 0]
    return lse - sharder.reduce(ll.masked_fill(~inside, 0.0))


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def train_loss(params: dict, cfg: ModelConfig, batch: dict,
               sharder=_noop_sharder, aux_coeff: float = 0.01, tokens=None,
               aux_weight=None) -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over the labels >= 0, plus the MoE
    load-balance loss times `aux_coeff` over the layers. Returns (total,
    {ce, aux, tokens}), 0-dim float32 tensors.

    A rank of a mesh passes its share of the global loss: `tokens`, the
    count its cross-entropy sum is divided by (default: this batch's
    labels >= 0), and `aux_weight`, which scales its load-balance term."""
    x = sharder("hidden", embed_inputs(params, cfg, batch, sharder))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    hidden, aux = forward_hidden(params, cfg, x, positions, sharder)
    logits = logits_fn(params, cfg, hidden, sharder)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    safe = torch.clamp_min(labels, 0)
    nll = _nll(logits, safe, cfg, sharder) * mask
    denom = torch.clamp_min(mask.sum(), 1.0) if tokens is None else tokens
    ce = nll.sum() / denom
    aux_term = aux_coeff * aux / max(cfg.n_layers, 1)
    if aux_weight is not None:
        aux_term = aux_term * aux_weight
    total = ce + aux_term
    return total, {"ce": ce, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda", tp: int = 1) -> dict:
    """The decode cache of `batch` rows (a rank's heads and channels of
    ``tp``)."""
    _check_family(cfg)
    dt = param_dtype(cfg)
    cache: Dict[str, Any] = {}
    if cfg.family in _ATTN:
        cache["kv"] = init_cache(cfg, batch, max_len, dt, device, tp)
    if cfg.family in _SSM:
        cache["ssm"] = init_ssm_cache(cfg, batch, dt, device, tp)
    return cache


def _put_ssm(sc: dict, i: int, conv_x: torch.Tensor, conv_bc: torch.Tensor,
             h: torch.Tensor) -> None:
    """Write layer `i`'s SSM decode state into the stacked cache."""
    sc["conv_x"][i].copy_(conv_x)
    sc["conv_bc"][i].copy_(conv_bc)
    sc["h"][i].copy_(h)


def _ssm_prefill(lp: dict, h: torch.Tensor, cfg: ModelConfig, sc: dict,
                 i: int, sharder) -> torch.Tensor:
    """Layer `i`'s SSM block over the prompt; keeps its decode state."""
    hn = common.rms_norm(h, lp["ssm_norm"], cfg.norm_eps)
    y, cx, cbc, hstate = ssm_mod.ssm_layer(lp["ssm"], hn, cfg,
                                           return_cache=True,
                                           sharder=sharder)
    _put_ssm(sc, i, cx, cbc, hstate)
    return y


def _ssm_decode(lp: dict, h: torch.Tensor, cfg: ModelConfig, sc: dict,
                i: int, sharder) -> torch.Tensor:
    """Layer `i`'s SSM block for one token; updates its decode state."""
    hn = common.rms_norm(h, lp["ssm_norm"], cfg.norm_eps)
    y, cx, cbc, hst = ssm_mod.ssm_decode_step(
        lp["ssm"], hn, sc["conv_x"][i], sc["conv_bc"][i], sc["h"][i], cfg,
        sharder)
    _put_ssm(sc, i, cx, cbc, hst)
    return y


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int,
            sharder=_noop_sharder) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, build the decode cache.

    Returns (last-position logits (B, V_pad), cache).
    """
    _check_family(cfg)
    x = sharder("hidden", embed_inputs(params, cfg, batch, sharder))
    dev = x.device
    b, s = x.shape[:2]
    positions = torch.arange(s, device=dev)
    cache = init_decode_cache(cfg, b, max_len, dev, sharder.tp)
    kv, sc = cache.get("kv"), cache.get("ssm")
    if kv is not None:
        # keep the last S_cache tokens, at ring slots pos % S_cache so
        # decode's write cursor stays consistent
        s_cache = kv["k"].shape[2]
        keep = min(s_cache, s)
        slots = torch.arange(s - keep, s, device=dev) % s_cache

    h = x
    for i, lp in enumerate(unstack_layers(params)):
        lp = sharder.layer(lp)
        if cfg.family == "ssm":
            h = sharder("hidden", h + _ssm_prefill(lp, h, cfg, sc, i,
                                                   sharder))
            continue
        hn = common.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = attention._project_qkv(lp["attn"], hn, positions, cfg,
                                         sharder)
        a = attention.flash_attention(q, k, v, positions, positions,
                                      cfg.sliding_window)
        a = attention._finish(lp["attn"], a, cfg, sharder)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = attention.quantize_kv(k[:, s - keep:])
            vq, vs = attention.quantize_kv(v[:, s - keep:])
            kv["k"][i][:, slots] = kq
            kv["v"][i][:, slots] = vq
            kv["k_scale"][i][:, slots] = ks
            kv["v_scale"][i][:, slots] = vs
        else:
            kv["k"][i][:, slots] = k[:, s - keep:]
            kv["v"][i][:, slots] = v[:, s - keep:]
        if cfg.family == "hybrid":
            h = h + 0.5 * (a + _ssm_prefill(lp, h, cfg, sc, i, sharder))
        else:
            h = h + a
        y, _ = _ffn(lp, h, cfg, sharder)
        h = sharder("hidden", h + y)
    hidden = common.rms_norm(
        h, sharder.gather(params["final_norm"], ("final_norm",)), cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden[:, -1:], sharder)[:, 0]

    if kv is not None:
        kv["positions"][slots] = torch.arange(s - keep, s, dtype=torch.int32,
                                              device=dev)
        kv["index"] = s
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig,
                token_or_embed: torch.Tensor, cache: dict,
                sharder=_noop_sharder) -> Tuple[torch.Tensor, dict]:
    """One decode step.

    token_or_embed: (B, 1) int tokens or (B, 1, D) embeddings.
    Returns (logits (B, V_pad) fp32, cache). The cache's k/v (and scales),
    positions and SSM state are updated in place; its index moves on by
    one.
    """
    _check_family(cfg)
    kv, sc = cache.get("kv"), cache.get("ssm")
    if token_or_embed.dim() == 2:
        x = _lookup(params, cfg, token_or_embed, sharder)
    else:
        x = token_or_embed.to(param_dtype(cfg))
    pos = int(kv["index"]) if kv is not None else 0   # current position
    if cfg.pos_emb == "sinusoidal":
        pe = common.sinusoidal_pos_emb(
            torch.full((1,), pos, device=x.device), cfg.d_model)
        x = x + pe[None].to(x.dtype)

    if kv is not None:
        s_cache = kv["k"].shape[2]
        slot = pos % s_cache
        kv["positions"][slot] = pos
    dt = param_dtype(cfg)

    h = x
    for i, lp in enumerate(unstack_layers(params)):
        lp = sharder.layer(lp)
        if cfg.family == "ssm":
            h = h + _ssm_decode(lp, h, cfg, sc, i, sharder)
            continue
        hn = common.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        k1, v1 = attention.decode_kv(lp["attn"], hn, pos, cfg, sharder)
        if cfg.kv_cache_dtype == "int8":
            k1q, k1s = attention.quantize_kv(k1)
            v1q, v1s = attention.quantize_kv(v1)
            kv["k"][i][:, slot] = k1q
            kv["v"][i][:, slot] = v1q
            kv["k_scale"][i][:, slot] = k1s
            kv["v_scale"][i][:, slot] = v1s
            layer_k = attention.dequantize_kv(kv["k"][i], kv["k_scale"][i],
                                              dt)
            layer_v = attention.dequantize_kv(kv["v"][i], kv["v_scale"][i],
                                              dt)
        else:
            kv["k"][i][:, slot] = k1
            kv["v"][i][:, slot] = v1
            layer_k, layer_v = kv["k"][i], kv["v"][i]
        a = attention.decode_attention(lp["attn"], hn, layer_k, layer_v,
                                       kv["positions"], pos, cfg, sharder)
        if cfg.family == "hybrid":
            h = h + 0.5 * (a + _ssm_decode(lp, h, cfg, sc, i, sharder))
        else:
            h = h + a
        y, _ = _ffn(lp, h, cfg, sharder)
        h = h + y

    hidden = common.rms_norm(
        h, sharder.gather(params["final_norm"], ("final_norm",)), cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden, sharder)[:, 0]
    if kv is not None:
        kv["index"] = pos + 1
    return logits, cache
