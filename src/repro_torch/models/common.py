"""Shared layers: norms, rotary embeddings, initializers.

Plain functions on tensors with the reference's signatures
(``repro.models.common``). Parameters are plain dicts of tensors created
by the ``*_init`` functions of each module; the random draws come from an
:class:`Init`, which holds one ``torch.Generator`` and one device (the
port's counterpart of a ``jax.random`` key). The two frameworks draw
different numbers from the same seed, so tests hand both packages the
same weights through numpy instead (``models.convert``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qk-norm)."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# Position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: broadcastable to
    x.shape[:-2] ending in S (usually (S,) or (B, S))."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions.float()[..., None] * freqs           # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (musicgen-style), (..., S, D) fp32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

_ERF2 = math.erf(2.0 / math.sqrt(2.0))


class Init:
    """Parameter draws from one ``torch.Generator`` onto one device.

    ``dense`` and ``embed`` draw a standard normal truncated to [-2, 2] by
    its inverse CDF (as ``jax.random.truncated_normal`` does), in float32,
    scale it and cast it to the parameter's dtype. Each call allocates only
    the float32 draw of one tensor, so a model is built one layer at a time
    without float32 temporaries of all its weights.
    """

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _trunc_normal(self, shape: Sequence[int]) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device,
                       dtype=torch.float32)
        u.mul_(2.0 * _ERF2).sub_(_ERF2)                  # in (-erf, erf)
        return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)

    def dense(self, shape: Sequence[int], in_axis_size: int,
              dtype: torch.dtype) -> torch.Tensor:
        """Truncated-normal fan-in init."""
        std = (1.0 / max(in_axis_size, 1)) ** 0.5
        return self._trunc_normal(shape).mul_(std).to(dtype)

    def embed(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        return self._trunc_normal(shape).mul_(0.02).to(dtype)

    def ones(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype, device=self.device)

    def zeros(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype, device=self.device)

    def const(self, values, dtype: torch.dtype) -> torch.Tensor:
        """A fixed tensor (``A_log``'s log-spaced decays), not a draw."""
        return torch.as_tensor(values, dtype=dtype, device=self.device)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a config's dtype string)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
