"""Plain PyTorch versions of the LM kernels.

The wrappers (``coalesced_gather.gather_rows``, ``moe_gmm.gmm``) take these
for tensors on the CPU; on the card only ``chip_smoke.py`` and the
``gpu`` tests call them, to hold the kernels against them. Indices are
clamped into range, as the reference's gathers clamp them.
"""

from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
            bm: int) -> torch.Tensor:
    """out[i] = x[i] @ w[block_expert[i // bm]], in float32, cast to
    ``x.dtype``. x: (M, K); w: (E, K, N); block_expert: (M // bm,).

    One batched product over the row blocks, each with its expert's
    weights (gathered per block, not per row).
    """
    m, k = x.shape
    e, _, n = w.shape
    nb = m // bm
    be = block_expert.long().clamp(0, e - 1)
    wg = w.index_select(0, be).float()                  # (M/bm, K, N)
    out = torch.bmm(x.reshape(nb, bm, k).float(), wg)
    return out.reshape(m, n).to(x.dtype)


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
