"""GQA attention: chunked online-softmax prefill path and KV-cache decode.

The reference's path is plain jnp, not its Pallas flash kernel (K5), so
the port's is plain PyTorch with the same arithmetic: query heads grouped
over KV heads, KV taken ``kv_chunk`` rows at a time with a running max and
sum. Layouts are the reference's: q (B, S, nq, hd), k/v (B, S, nkv, hd),
caches (L, B, S_cache, nkv, hd). Pad query heads (tensor-parallel padding
of ModelConfig) are zero-masked before the output projection.

Under tensor parallelism (a ``sharder`` with ``tp`` > 1) a rank computes
its own heads: ``wq``/``wk``/``wv`` are its column shards (its
``n_q_eff / tp`` query and ``n_kv_eff / tp`` KV heads, the same GQA
groups), ``wo`` its row shard, whose partial output is summed over the
ranks (Megatron's "reduce"); the input enters through its "copy", and so
do ``q_norm``/``k_norm``, which each rank applies to its heads alone.
The KV cache holds the rank's KV heads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import sharding
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


def _head_mask(cfg: ModelConfig, dtype: torch.dtype, device,
               n: Optional[int] = None, first: int = 0) -> torch.Tensor:
    """(n,) 1.0 for real heads, 0.0 for TP pad heads, of the `n` query
    heads from `first` on (default: all ``n_q_eff``)."""
    n = cfg.n_q_eff if n is None else n
    return (torch.arange(first, first + n, device=device)
            < cfg.n_heads).to(dtype)


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, sharder=None):
    """x: (B, S, D) -> q (B,S,nq,hd), k/v (B,S,nkv,hd), roped + normed
    (the rank's heads under tensor parallelism)."""
    sh = sharder or sharding.NO_SHARDER
    x = sh.copy(x)
    b, s, _ = x.shape
    hd = cfg.head_dim
    wk, wv = params["wk"], params["wv"]
    kv = _kv_block(cfg, sh, params["wq"].shape[1] // hd)
    if kv is not None:
        wk = sh.gather_tp(wk, 1, cfg.n_kv_eff * hd)
        wv = sh.gather_tp(wv, 1, cfg.n_kv_eff * hd)
    q = torch.matmul(x, params["wq"]).reshape(b, s, -1, hd)
    k = torch.matmul(x, wk).reshape(b, s, -1, hd)
    v = torch.matmul(x, wv).reshape(b, s, -1, hd)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    if cfg.qk_norm:
        q = common.head_rms_norm(q, sh.copy(params["q_norm"]), cfg.norm_eps)
        k = common.head_rms_norm(k, sh.copy(params["k_norm"]), cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_block(cfg: ModelConfig, sh, nq: int) -> Optional[slice]:
    """None when the rank's KV heads are its block of ``wk``/``wv`` (no
    tensor parallelism, or the model axis divides ``n_kv_eff``); else the
    KV heads its `nq` query heads read, which straddle the ranks' blocks
    (fewer KV heads than ranks): ``wk``/``wv`` are then taken whole over
    the model axis and cut to these."""
    if sh.tp == 1:
        return None
    if cfg.n_q_eff % sh.tp:
        raise ValueError(
            f"{cfg.name}: {cfg.n_q_eff} query heads do not divide over "
            f"{sh.tp} model ranks (set tp_divisor to pad them)")
    if cfg.n_kv_eff % sh.tp == 0:
        return None
    g = cfg.n_q_eff // cfg.n_kv_eff
    first = sh.tp_rank * nq
    lo, hi = first // g, (first + nq - 1) // g + 1
    per = nq // (hi - lo)
    if nq % (hi - lo) or any((first + j) // g - lo != j // per
                             for j in range(nq)):
        raise ValueError(
            f"{cfg.name}: the query heads of a rank ({nq}) do not map onto "
            f"whole groups of its {cfg.n_kv_eff} KV heads")
    return slice(lo, hi)


def _finish(params: dict, out: torch.Tensor, cfg: ModelConfig,
            sharder=None) -> torch.Tensor:
    """out: (B, S, nq, hd) -> (B, S, D), masking TP pad heads (the rank's
    heads, summed over the ranks, under tensor parallelism)."""
    sh = sharder or sharding.NO_SHARDER
    b, s, nq = out.shape[:3]
    mask = _head_mask(cfg, out.dtype, out.device, nq, sh.tp_rank * nq)
    out = out * mask[None, None, :, None]
    out = out.reshape(b, s, nq * cfg.head_dim)
    return sh.reduce(torch.matmul(out, params["wo"]))


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
              cfg: ModelConfig, kv_chunk: int = KV_CHUNK,
              sharder=None) -> torch.Tensor:
    """Full causal self-attention block (prefill). x: (B,S,D)."""
    q, k, v = _project_qkv(params, x, positions, cfg, sharder)
    out = flash_attention(q, k, v, positions, positions,
                          cfg.sliding_window, kv_chunk)
    return _finish(params, out, cfg, sharder)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device="cuda", tp: int = 1) -> dict:
    """Per-layer stacked KV cache.

    k, v: (L, B, S_cache, nkv, hd); positions: (S_cache,) int32 (-1 =
    empty); index: the next write cursor (monotone token position count),
    kept on the host as a Python int because the host loop sets it before
    every decode step. For sliding-window configs S_cache == window and
    writes wrap (ring buffer); otherwise S_cache == max sequence length.
    With `tp` > 1, a rank's cache of its ``n_kv_eff / tp`` KV heads.
    """
    if cfg.n_kv_eff % tp:
        raise ValueError(
            f"{cfg.name}: a KV cache of {cfg.n_kv_eff} heads does not divide "
            f"over {tp} model ranks (set tp_divisor to pad them)")
    s_cache = (min(max_len, cfg.sliding_window) if cfg.sliding_window
               else max_len)
    shape = (cfg.n_layers, batch, s_cache, cfg.n_kv_eff // tp,
             cfg.head_dim)
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
                     pos: Union[int, torch.Tensor], cfg: ModelConfig,
                     sharder=None) -> torch.Tensor:
    """One-token attention against the cache for a single layer.

    x: (B, 1, D); layer_k/v: (B, S_cache, nkv, hd) *already updated* with
    this step's k/v; pos: the current position. Returns (B, 1, D).
    """
    b = x.shape[0]
    hd = cfg.head_dim
    q, _, _ = _project_qkv(params, x, _pos_tensor(pos, x.device), cfg,
                           sharder)
    nq, nkv = q.shape[2], layer_k.shape[2]
    g = nq // nkv
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
    return _finish(params, out, cfg, sharder)


def decode_kv(params: dict, x: torch.Tensor, pos: Union[int, torch.Tensor],
              cfg: ModelConfig, sharder=None):
    """Project this step's k, v for cache insertion. x: (B,1,D)."""
    _, k, v = _project_qkv(params, x, _pos_tensor(pos, x.device), cfg,
                           sharder)
    return k[:, 0], v[:, 0]        # (B, nkv, hd)
