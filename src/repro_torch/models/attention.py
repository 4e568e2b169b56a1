"""GQA attention: chunked online-softmax prefill path and KV-cache decode.

The reference's path is plain jnp, not its Pallas flash kernel (K5), so
the port's is plain PyTorch with the same arithmetic: query heads grouped
over KV heads, KV taken ``kv_chunk`` rows at a time with a running max and
sum. Layouts are the reference's: q (B, S, nq, hd), k/v (B, S, nkv, hd),
caches (L, B, S_cache, nkv, hd). Pad query heads (tensor-parallel padding
of ModelConfig) are zero-masked before the output projection.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models import common
from repro_torch.models.common import Init
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0e38
#: KV rows a step of the online softmax takes (the reference's default).
KV_CHUNK = 1024


def attn_init(init: Init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_q_eff, cfg.n_kv_eff
    p = {
        "wq": init.dense((d, nq * hd), d, dtype),
        "wk": init.dense((d, nkv * hd), d, dtype),
        "wv": init.dense((d, nkv * hd), d, dtype),
        "wo": init.dense((nq * hd, d), nq * hd, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.ones((hd,), dtype)
        p["k_norm"] = init.ones((hd,), dtype)
    return p


def _head_mask(cfg: ModelConfig, dtype: torch.dtype,
               device) -> torch.Tensor:
    """(nq_eff,) 1.0 for real heads, 0.0 for TP pad heads."""
    return (torch.arange(cfg.n_q_eff, device=device) < cfg.n_heads).to(dtype)


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    """x: (B, S, D) -> q (B,S,nq,hd), k/v (B,S,nkv,hd), roped + normed."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = torch.matmul(x, params["wq"]).reshape(b, s, cfg.n_q_eff, hd)
    k = torch.matmul(x, params["wk"]).reshape(b, s, cfg.n_kv_eff, hd)
    v = torch.matmul(x, params["wv"]).reshape(b, s, cfg.n_kv_eff, hd)
    if cfg.qk_norm:
        q = common.head_rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = common.head_rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _finish(params: dict, out: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """out: (B, S, nq, hd) -> (B, S, D), masking TP pad heads."""
    b, s = out.shape[:2]
    out = out * _head_mask(cfg, out.dtype, out.device)[None, None, :, None]
    out = out.reshape(b, s, cfg.n_q_eff * cfg.head_dim)
    return torch.matmul(out, params["wo"])


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    window: Optional[int], kv_chunk: int = KV_CHUNK
                    ) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd). Causal w.r.t. positions,
    optionally sliding-window. Returns (B, Sq, nq, hd).
    """
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = 1.0 / (hd ** 0.5)
    qh = (q.reshape(b, sq, nkv, g, hd).permute(0, 2, 3, 1, 4).float()
          * scale)                                        # (B,nkv,G,Sq,hd)

    kv_chunk = min(kv_chunk, sk)
    if sk % kv_chunk:
        pad = kv_chunk - sk % kv_chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=-1)
        sk += pad
    nchunk = sk // kv_chunk
    kc = k.reshape(b, nchunk, kv_chunk, nkv, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nchunk, kv_chunk, nkv, hd).permute(1, 0, 3, 2, 4)
    kpos = k_positions.reshape(nchunk, kv_chunk)

    m = torch.full((b, nkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nkv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for c in range(nchunk):
        kb, vb, kp = kc[c], vc[c], kpos[c]
        s = torch.einsum("bngqd,bnkd->bngqk", qh, kb.float())
        valid = q_positions[:, None] >= kp[None, :]      # (Sq, C) causal
        if window is not None:
            valid &= (q_positions[:, None] - kp[None, :]) < window
        valid &= (kp >= 0)[None, :]
        s = torch.where(valid[None, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bngqk,bnkd->bngqd", p, vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, nq, hd)
    return out.to(q.dtype)


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Full causal self-attention block (prefill). x: (B,S,D)."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    out = flash_attention(q, k, v, positions, positions,
                          cfg.sliding_window, kv_chunk)
    return _finish(params, out, cfg)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device="cuda") -> dict:
    """Per-layer stacked KV cache.

    k, v: (L, B, S_cache, nkv, hd); positions: (S_cache,) int32 (-1 =
    empty); index: the next write cursor (monotone token position count),
    kept on the host as a Python int because the host loop sets it before
    every decode step. For sliding-window configs S_cache == window and
    writes wrap (ring buffer); otherwise S_cache == max sequence length.
    """
    s_cache = (min(max_len, cfg.sliding_window) if cfg.sliding_window
               else max_len)
    shape = (cfg.n_layers, batch, s_cache, cfg.n_kv_eff, cfg.head_dim)
    cache = {
        "positions": torch.full((s_cache,), -1, dtype=torch.int32,
                                device=device),
        "index": 0,
    }
    if cfg.kv_cache_dtype == "int8":
        # Quantized KV: int8 payload + per-(token, head) bf16 scales.
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def quantize_kv(x: torch.Tensor):
    """x: (..., hd) -> (int8 payload, bf16 scale over trailing dim)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def _pos_tensor(pos: Union[int, torch.Tensor], device) -> torch.Tensor:
    """(1,) int32 on `device` (a fill, not a host copy, for an int)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


def decode_attention(params: dict, x: torch.Tensor, layer_k: torch.Tensor,
                     layer_v: torch.Tensor, cache_positions: torch.Tensor,
                     pos: Union[int, torch.Tensor], cfg: ModelConfig
                     ) -> torch.Tensor:
    """One-token attention against the cache for a single layer.

    x: (B, 1, D); layer_k/v: (B, S_cache, nkv, hd) *already updated* with
    this step's k/v; pos: the current position. Returns (B, 1, D).
    """
    b = x.shape[0]
    hd = cfg.head_dim
    nq, nkv = cfg.n_q_eff, cfg.n_kv_eff
    g = nq // nkv
    q, _, _ = _project_qkv(params, x, _pos_tensor(pos, x.device), cfg)
    qh = (q.reshape(b, 1, nkv, g, hd).permute(0, 2, 3, 1, 4).float()
          / (hd ** 0.5))                                  # (B,nkv,G,1,hd)
    s = torch.einsum("bngqd,bknd->bngqk", qh, layer_k.float())
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if cfg.sliding_window is not None:
        valid &= (pos - cache_positions) < cfg.sliding_window
    s = torch.where(valid[None, None, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bngqd", p, layer_v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, nq, hd).to(x.dtype)
    return _finish(params, out, cfg)


def decode_kv(params: dict, x: torch.Tensor, pos: Union[int, torch.Tensor],
              cfg: ModelConfig):
    """Project this step's k, v for cache insertion. x: (B,1,D)."""
    _, k, v = _project_qkv(params, x, _pos_tensor(pos, x.device), cfg)
    return k[:, 0], v[:, 0]        # (B, nkv, hd)
