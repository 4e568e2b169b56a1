"""Mamba2 (SSD, state-space duality) block: the chunked parallel scan for
prefill and a single-step recurrence for decode.

The port of ``repro.models.ssm`` (arXiv:2405.21060). Per head h, with a
scalar decay ``a_t = exp(dt_t * A_h)`` and per-group B/C of width N:

    h_t = a_t * h_{t-1} + dt_t * B_t ⊗ x_t          (state: P x N per head)
    y_t = C_t · h_t + D_h * x_t

The chunked scan computes the intra-chunk part as a masked quadratic form
(chunk x chunk) and carries the state across chunks; ``lax.scan`` over
chunks becomes a Python loop. It stays plain PyTorch, as the reference's
stays plain jnp: K6 (``kernels.ssd_scan``) computes the same scan without
``h0`` and ``h_final``, and neither package wires it into the model.

The reference's padding is kept exactly: S is padded up to a multiple of
the chunk with ``dt = 0``, and softplus(0) = ln 2, so the padded steps
still decay the state. ``y`` is sliced back and is right; ``h_final`` of a
prompt longer than the chunk and not a multiple of it is not, and decode
starts from it, in both packages.

Under tensor parallelism (a ``sharder`` with ``tp`` > 1) a rank computes
its own channels and heads, as the reference's layout shards them:
``z_proj``/``x_proj`` are its column shards (``d_inner / tp`` channels,
``ssm_heads / tp`` heads), ``conv_x_*``, ``norm``, ``A_log``, ``D`` and
``dt_bias`` its slices, ``out_proj`` its row shard, whose partial output
is summed over the ranks. ``bc_proj``, ``dt_proj`` and ``conv_bc_*``
stay whole on every rank (through Megatron's "copy", as each rank uses
them for its heads alone), and ``dt`` is cut to the rank's heads. The
gated RMSNorm's mean of squares runs over the whole ``d_inner``: a sum
over the ranks. The decode state holds the rank's channels and heads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def ssm_init(init, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """One layer's SSM parameters; `init` is a :class:`~common.Init` (or any
    object with its methods). ``A_log``, ``D`` and ``dt_bias`` are float32."""
    d, di = cfg.d_model, cfg.d_inner
    nh, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    k = cfg.ssm_conv
    f32 = torch.float32
    return {
        "z_proj": init.dense((d, di), d, dtype),
        "x_proj": init.dense((d, di), d, dtype),
        "bc_proj": init.dense((d, 2 * g * n), d, dtype),
        "dt_proj": init.dense((d, nh), d, dtype),
        "conv_x_w": init.dense((k, di), k, dtype),
        "conv_x_b": init.zeros((di,), dtype),
        "conv_bc_w": init.dense((k, 2 * g * n), k, dtype),
        "conv_bc_b": init.zeros((2 * g * n,), dtype),
        "A_log": init.const(np.log(np.arange(1, nh + 1, dtype=np.float32)),
                            f32),
        "D": init.ones((nh,), f32),
        "dt_bias": init.zeros((nh,), f32),
        "norm": init.ones((di,), dtype),
        "out_proj": init.dense((di, d), di, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C); w: (K,C). Returns (y, new_state)
    where state carries the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    y = F.silu(y + b[None, None, :])
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return y, new_state


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device="cuda", tp: int = 1) -> dict:
    """Stacked per-layer SSM decode state (plain dict):
    conv_x (L,B,K-1,di), conv_bc (L,B,K-1,2gn), h (L,B,nh,P,N) fp32 (a
    rank's ``di / tp`` channels and ``nh / tp`` heads with `tp` > 1)."""
    di, g, n = cfg.d_inner // tp, cfg.ssm_groups, cfg.ssm_state
    nh, p = cfg.ssm_heads // tp, cfg.ssm_headdim
    km1 = cfg.ssm_conv - 1
    L = cfg.n_layers
    return {
        "conv_x": torch.zeros((L, batch, km1, di), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((L, batch, km1, 2 * g * n), dtype=dtype,
                               device=device),
        "h": torch.zeros((L, batch, nh, p, n), dtype=torch.float32,
                         device=device),
    }


# ---------------------------------------------------------------------------
# Chunked SSD scan (prefill)
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = sum_{j<k<=i} a_k.

    a: (..., Q). Returns (..., Q, Q) with -inf above the diagonal.
    """
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD. x: (B,S,nh,P); dt raw: (B,S,nh); b,c: (B,S,g,N).

    Returns (y (B,S,nh,P) in x's dtype, h_final (B,nh,P,N) fp32).
    """
    bsz, s_orig, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = nh // g
    b = b.repeat_interleave(rep, dim=2).float()              # (B,S,nh,N)
    c = c.repeat_interleave(rep, dim=2).float()
    s = s_orig
    q = min(chunk, s)
    if s % q:
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // q

    xf = x.float()
    dtf = F.softplus(dt.float())                             # (B,S,nh)
    da = dtf * (-torch.exp(a_log.float()))[None, None, :]    # decay logs <= 0
    xdt = xf * dtf[..., None]                                # dt-weighted input

    def rs(t):   # (B,S,rest...) -> (nc, B, q, rest...)
        return t.reshape(bsz, nc, q, *t.shape[2:]).movedim(1, 0)

    xc, dac = rs(xdt), rs(da)
    bc_, cc_ = rs(b), rs(c)                                  # (nc,B,q,nh,N)

    # Intra-chunk (quadratic within the chunk, like masked attention):
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))       # (nc,B,nh,q,q)
    cb = torch.einsum("cbqhn,cbkhn->cbhqk", cc_, bc_)        # (nc,B,nh,q,q)
    y_intra = torch.einsum("cbhqk,cbkhp->cbqhp", cb * lmat, xc)

    # Inter-chunk: carried state.
    dacs = torch.cumsum(dac, dim=2)                          # (nc,B,q,nh)
    decay_to_end = torch.exp(dacs[:, :, -1:, :] - dacs)      # (nc,B,q,nh)
    chunk_states = torch.einsum("cbkhn,cbkh,cbkhp->cbhpn",
                                bc_, decay_to_end, xc)       # (nc,B,nh,P,N)
    chunk_decay = torch.exp(dacs[:, :, -1, :])               # (nc,B,nh)

    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[ci][..., None, None] + chunk_states[ci]
    h_prevs = torch.stack(h_prevs)                           # (nc,B,nh,P,N)
    decay_from_start = torch.exp(dacs)                       # (nc,B,q,nh)
    y_inter = torch.einsum("cbqhn,cbqh,cbhpn->cbqhp",
                           cc_, decay_from_start, h_prevs)

    y = (y_intra + y_inter).movedim(0, 1).reshape(bsz, s, nh, p)
    y = y + xf * d_skip.float()[None, None, :, None]
    return y[:, :s_orig].to(x.dtype), h


def _project(params: dict, xin: torch.Tensor, cfg: ModelConfig,
             sh=sharding.NO_SHARDER):
    """The input projections; `dt` and the conv_bc weights for the rank's
    heads (whole without tensor parallelism)."""
    if cfg.ssm_heads % sh.tp:
        raise ValueError(
            f"{cfg.name}: {cfg.ssm_heads} SSM heads do not divide over "
            f"{sh.tp} model ranks (set tp_divisor)")
    xin = sh.copy(xin)
    z = torch.matmul(xin, params["z_proj"])
    xs = torch.matmul(xin, params["x_proj"])
    bc = torch.matmul(xin, sh.copy(params["bc_proj"]))
    dt = torch.matmul(xin, sh.copy(params["dt_proj"]))
    if sh.tp > 1:
        nh = params["A_log"].shape[0]
        dt = dt[..., sh.tp_rank * nh:(sh.tp_rank + 1) * nh]
    return z, xs, bc, dt, sh.copy(params["conv_bc_w"]), \
        sh.copy(params["conv_bc_b"])


def _heads_bc(b: torch.Tensor, cfg: ModelConfig, sh, nh: int
              ) -> torch.Tensor:
    """(..., g, N) B or C -> the groups of the rank's `nh` heads, one a
    head (itself without tensor parallelism)."""
    if sh.tp == 1:
        return b
    rep = cfg.ssm_heads // cfg.ssm_groups
    first = sh.tp_rank * nh
    return b.repeat_interleave(rep, dim=-2)[..., first:first + nh, :]


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, sh) -> torch.Tensor:
    """rms_norm(y * silu(z)) @ out_proj, with the reference's casts; under
    tensor parallelism the norm's mean of squares is over every rank's
    channels and the output the ranks' sum."""
    y = y * F.silu(z.float()).to(y.dtype)
    if sh.tp == 1:
        y = common.rms_norm(y, params["norm"], cfg.norm_eps)
    else:
        yf = y.float()
        var = sh.psum(torch.sum(yf * yf, dim=-1, keepdim=True)) / cfg.d_inner
        y = (yf * torch.rsqrt(var + cfg.norm_eps)
             * params["norm"].float()).to(y.dtype)
    return sh.reduce(torch.matmul(y, params["out_proj"]))


def ssm_layer(params: dict, xin: torch.Tensor, cfg: ModelConfig,
              return_cache: bool = False, sharder=None):
    """Full-sequence Mamba2 block. xin: (B,S,D) -> (B,S,D).

    With ``return_cache=True`` also returns (conv_x, conv_bc, h_final) for
    switching into decode after prefill.
    """
    sh = sharder or sharding.NO_SHARDER
    z, xs, bc, dt, cbc_w, cbc_b = _project(params, xin, cfg, sh)
    xs_c, _ = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"])
    bc_c, _ = _causal_conv(bc, cbc_w, cbc_b)
    g, n = cfg.ssm_groups, cfg.ssm_state
    bsz, s, di = xs_c.shape
    nh = di // cfg.ssm_headdim
    x = xs_c.reshape(bsz, s, nh, cfg.ssm_headdim)
    b, c = torch.chunk(bc_c, 2, dim=-1)
    b = _heads_bc(b.reshape(bsz, s, g, n), cfg, sh, nh)
    c = _heads_bc(c.reshape(bsz, s, g, n), cfg, sh, nh)
    dt = dt.float() + params["dt_bias"][None, None, :]
    y, h_last = ssd_scan(x, dt, params["A_log"], b, c, params["D"],
                         cfg.ssm_chunk)
    out = _gate_out(params, y.reshape(bsz, s, di), z, cfg, sh)
    if return_cache:
        k = cfg.ssm_conv

        def tail(t):
            if t.shape[1] >= k - 1:
                return t[:, t.shape[1] - (k - 1):, :]
            return F.pad(t, (0, 0, k - 1 - t.shape[1], 0))

        return out, tail(xs), tail(bc), h_last
    return out


# ---------------------------------------------------------------------------
# Single-step decode recurrence
# ---------------------------------------------------------------------------


def ssm_decode_step(params: dict, xin: torch.Tensor, conv_x: torch.Tensor,
                    conv_bc: torch.Tensor, h: torch.Tensor,
                    cfg: ModelConfig, sharder=None):
    """One token. xin: (B,1,D); conv_x: (B,K-1,di); conv_bc: (B,K-1,2gn);
    h: (B,nh,P,N) fp32. Returns (y (B,1,D), conv_x', conv_bc', h')."""
    sh = sharder or sharding.NO_SHARDER
    z, xs, bc, dt, cbc_w, cbc_b = _project(params, xin, cfg, sh)
    xs_c, new_conv_x = _causal_conv(xs, params["conv_x_w"],
                                    params["conv_x_b"], state=conv_x)
    bc_c, new_conv_bc = _causal_conv(bc, cbc_w, cbc_b, state=conv_bc)
    g, n = cfg.ssm_groups, cfg.ssm_state
    bsz, _, di = xs_c.shape
    p = cfg.ssm_headdim
    nh = di // p
    x = xs_c[:, 0].reshape(bsz, nh, p).float()
    b, c = torch.chunk(bc_c[:, 0], 2, dim=-1)
    b = _heads_bc(b.reshape(bsz, g, n), cfg, sh, nh).float()
    c = _heads_bc(c.reshape(bsz, g, n), cfg, sh, nh).float()
    rep = nh // b.shape[1]
    br = b.repeat_interleave(rep, dim=1)                    # (B,nh,N)
    cr = c.repeat_interleave(rep, dim=1)

    dtf = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    decay = torch.exp(dtf * (-torch.exp(params["A_log"]))[None, :])
    h_new = (h * decay[..., None, None]
             + torch.einsum("bhp,bhn->bhpn", x * dtf[..., None], br))
    y = (torch.einsum("bhn,bhpn->bhp", cr, h_new)
         + x * params["D"][None, :, None])
    y = y.reshape(bsz, 1, di).to(xin.dtype)
    return _gate_out(params, y, z, cfg, sh), new_conv_x, new_conv_bc, h_new
