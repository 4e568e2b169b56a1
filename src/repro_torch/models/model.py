"""LM assembly: embedding, layers, logits, prefill, decode.

The port of ``repro.models.model`` for the ``dense`` and ``moe`` families.
Parameters keep the reference's names and its stacked ``(L, ...)`` layer
layout, so a tree of the reference's weights carries over leaf for leaf
(``models.convert``); ``lax.scan`` over that axis becomes a Python loop
over views of it. The ``ssm`` and ``hybrid`` families need
``models/ssm.py``, which comes with a later slice, and raise here;
``train_loss`` comes with the training slice.

Everything runs on the device the parameters lie on. Decode updates the
KV cache it is given in place (the reference returns a new one), which
saves a copy of the whole cache each step; it returns the cache as well,
so callers read the same as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention, common, mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import init_cache
from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig

FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} needs models/ssm.py, which comes with "
            "the next slice of the port")


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
    p: Dict[str, Any] = {
        "attn_norm": init.ones((cfg.d_model,), dt),
        "attn": attention.attn_init(init, cfg, dt),
        "mlp_norm": init.ones((cfg.d_model,), dt),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(init, cfg, dt)
    else:
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
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Layer bodies (full sequence)
# ---------------------------------------------------------------------------


def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig):
    """The layer's MLP or MoE on the normed hidden; returns (y, aux)."""
    hn = common.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_layer(lp["moe"], hn, cfg)
    return mlp_mod.mlp(lp["mlp"], hn, cfg), None


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    h = common.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + attention.attention(lp["attn"], h, positions, cfg)
    y, aux = _ffn(lp, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def forward_hidden(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded input (B,S,D) -> final hidden (B,S,D), summed aux loss."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _layer_fwd(layer_params(params, i), x, positions, cfg)
        aux = aux + a
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> torch.Tensor:
    """tokens (B,S) int or input_embeds (B,S,D) -> (B,S,D)."""
    if "input_embeds" in batch:
        x = batch["input_embeds"].to(param_dtype(cfg))
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.pos_emb == "sinusoidal":
        s = x.shape[1]
        pe = common.sinusoidal_pos_emb(torch.arange(s, device=x.device),
                                       cfg.d_model)
        x = x + pe[None].to(x.dtype)
    return x


def logits_fn(params: dict, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    """(B,S,D) -> (B,S,V_pad) fp32, pad vocab masked to -1e9."""
    head = (params["embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.matmul(hidden, head).float()
    pad = torch.arange(cfg.vocab_padded, device=hidden.device) >= \
        cfg.vocab_size
    return logits.masked_fill(pad[None, None, :], -1e9)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> dict:
    _check_family(cfg)
    return {"kv": init_cache(cfg, batch, max_len, param_dtype(cfg),
                             device)}


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int
            ) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, build the decode cache.

    Returns (last-position logits (B, V_pad), cache).
    """
    _check_family(cfg)
    x = embed_inputs(params, cfg, batch)
    dev = x.device
    b, s = x.shape[:2]
    positions = torch.arange(s, device=dev)
    cache = init_decode_cache(cfg, b, max_len, dev)
    kv = cache["kv"]
    # keep the last S_cache tokens, at ring slots pos % S_cache so
    # decode's write cursor stays consistent
    s_cache = kv["k"].shape[2]
    keep = min(s_cache, s)
    slots = torch.arange(s - keep, s, device=dev) % s_cache

    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        hn = common.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = attention._project_qkv(lp["attn"], hn, positions, cfg)
        a = attention.flash_attention(q, k, v, positions, positions,
                                      cfg.sliding_window)
        a = attention._finish(lp["attn"], a, cfg)
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
        h = h + a
        y, _ = _ffn(lp, h, cfg)
        h = h + y
    hidden = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden[:, -1:])[:, 0]

    kv["positions"][slots] = torch.arange(s - keep, s, dtype=torch.int32,
                                          device=dev)
    kv["index"] = s
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig,
                token_or_embed: torch.Tensor, cache: dict
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step.

    token_or_embed: (B, 1) int tokens or (B, 1, D) embeddings.
    Returns (logits (B, V_pad) fp32, cache). The cache's k/v (and scales)
    and positions are updated in place; its index moves on by one.
    """
    _check_family(cfg)
    kv = cache["kv"]
    if token_or_embed.dim() == 2:
        x = params["embed"][token_or_embed.long()]
    else:
        x = token_or_embed.to(param_dtype(cfg))
    pos = int(kv["index"])                          # current position
    if cfg.pos_emb == "sinusoidal":
        pe = common.sinusoidal_pos_emb(
            torch.full((1,), pos, device=x.device), cfg.d_model)
        x = x + pe[None].to(x.dtype)

    s_cache = kv["k"].shape[2]
    slot = pos % s_cache
    kv["positions"][slot] = pos
    dt = param_dtype(cfg)

    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        hn = common.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        k1, v1 = attention.decode_kv(lp["attn"], hn, pos, cfg)
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
                                       kv["positions"], pos, cfg)
        h = h + a
        y, _ = _ffn(lp, h, cfg)
        h = h + y

    hidden = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden)[:, 0]
    kv["index"] = pos + 1
    return logits, cache
