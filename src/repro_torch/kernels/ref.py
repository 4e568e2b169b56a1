"""Plain PyTorch versions of the LM kernels, and the SSD oracles.

The wrappers (``coalesced_gather.gather_rows``, ``moe_gmm.gmm``,
``flash_attention.flash_attention``, ``ssd_scan.ssd_scan_kernel``) take these
for tensors on the CPU; on the card only ``chip_smoke.py`` and the
``gpu`` tests call them, to hold the kernels against them. Indices are
clamped into range, as the reference's gathers clamp them.
"""

from __future__ import annotations

from typing import Optional

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
            bm: int, n_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = x[i] @ w[block_expert[i // bm]], in float32, cast to
    ``x.dtype``. x: (M, K); w: (E, K, N); block_expert: (M // bm,). Rows
    at or past ``n_rows`` (a one-element tensor, clamped into [0, M]) are
    zero; ``None`` keeps every row.

    One batched product over the row blocks, each with its expert's
    weights (gathered per block, not per row).
    """
    m, k = x.shape
    e, _, n = w.shape
    nb = m // bm
    be = block_expert.long().clamp(0, e - 1)
    wg = w.index_select(0, be).float()                  # (M/bm, K, N)
    out = torch.bmm(x.reshape(nb, bm, k).float(), wg).reshape(m, n)
    if n_rows is not None:
        rows = torch.arange(m, device=x.device)[:, None]
        out = torch.where(rows < n_rows.reshape(()).to(x.device), out,
                          torch.zeros((), device=x.device))
    return out.to(x.dtype)


def gather_rows_ref(x: torch.Tensor, row_src: torch.Tensor,
                    row_valid: torch.Tensor, t_pad: int) -> torch.Tensor:
    """out[j] = x[row_src[j]] if row_valid[j] else 0, j in [0, t_pad)."""
    t = x.shape[0]
    src = row_src.long().clamp(0, max(t - 1, 0))
    if t == 0:
        return torch.zeros((t_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
    out = x.index_select(0, src)
    return torch.where(row_valid[:, None] > 0, out,
                       torch.zeros((), dtype=x.dtype, device=x.device))


NEG_INF = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Softmax attention, q, k, v: (BH, S, hd) -> (BH, Sq, hd) in
    ``q.dtype``; scale ``1/sqrt(hd)``, masked scores -2e38, float32
    throughout."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full((), NEG_INF,
                                                  device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_scan_ref(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> torch.Tensor:
    """K6's function: the Mamba2 SSD chunked scan with the state starting
    at 0 and no D-skip. xdt: (BH, S, P); da: (BH, S) decay logs; b, c:
    (BH, S, N); S % chunk == 0. Returns y (BH, S, P) in ``xdt.dtype``.

    Per chunk, vectorised over BH: ``cs = cumsum(da)``,
    ``y = (C Bᵀ ∘ L) xdt + (C ∘ exp(cs)) hᵀ`` with ``L[i, j] =
    exp(cs_i - cs_j)`` for j <= i (masked before the exp), then
    ``h = h exp(cs_last) + xdtᵀ (B ∘ exp(cs_last - cs))``.
    """
    bh, s, p = xdt.shape
    n = b.shape[-1]
    q = chunk
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=xdt.device)
    out = torch.empty((bh, s, p), dtype=torch.float32, device=xdt.device)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xdt.device))
    neg = torch.full((), -torch.inf, device=xdt.device)
    for c0 in range(0, s, q):
        x = xdt[:, c0:c0 + q].float()
        bb = b[:, c0:c0 + q].float()
        cc = c[:, c0:c0 + q].float()
        cs = torch.cumsum(da[:, c0:c0 + q].float(), dim=-1)     # (BH, Q)
        lmat = torch.exp(torch.where(mask, cs[:, :, None] - cs[:, None, :],
                                     neg))
        y = torch.bmm(torch.bmm(cc, bb.transpose(1, 2)) * lmat, x)
        y += torch.bmm(cc * torch.exp(cs)[..., None], h.transpose(1, 2))
        w = torch.exp(cs[:, -1:] - cs)[..., None]                # (BH, Q, 1)
        h = (h * torch.exp(cs[:, -1])[:, None, None]
             + torch.bmm(x.transpose(1, 2), bb * w))
        out[:, c0:c0 + q] = y
    return out.to(xdt.dtype)


def ssd_seq_ref(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """The sequential recurrence K6 computes in chunks, one step at a
    time: ``h = h exp(da_t) + xdt_t ⊗ b_t``, ``y_t = h c_t``. Returns y
    (BH, S, P) in float32."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(s):
        h = (h * torch.exp(da[:, t].float())[:, None, None]
             + xdt[:, t].float()[:, :, None] * b[:, t].float()[:, None, :])
        ys.append(torch.einsum("bn,bpn->bp", c[:, t].float(), h))
    return torch.stack(ys, dim=1)


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                  chunk: int):
    """Sequential (non-chunked) SSD recurrence oracle, with the raw dt,
    A and D-skip of the model (``chunk`` is unused, as in the
    reference). x: (B,S,nh,P); dt raw (B,S,nh); b, c: (B,S,nh,N).
    Returns (y in ``x.dtype``, h_last (B,nh,P,N) float32)."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    dtf = torch.nn.functional.softplus(dt.float())
    decay = torch.exp(dtf * (-torch.exp(a_log.float()))[None, None, :])
    xf, bf, cf = x.float(), b.float(), c.float()
    h = torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = (h * decay[:, t][..., None, None]
             + torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t][..., None],
                            bf[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=1) + xf * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), h
