"""Dispatch wrappers of the LM kernels, with the reference's signatures
(``repro.kernels.ops``).

``coalesced_gather`` builds the per-destination-row source map and
launches K3 at every size: the Hopper kernel reads rows straight from
device memory, so the reference's VMEM budget and its XLA fallback have no
counterpart here. ``moe_gmm`` launches K4. The flash-attention and SSD
wrappers come with their kernels (K5, K6) in a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import coalesced_gather as _gather_k
from repro_torch.kernels import moe_gmm as _gmm_k


def moe_gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
            block: int = 128) -> torch.Tensor:
    """Grouped matmul over BM-aligned expert groups."""
    return _gmm_k.gmm(x, w, block_expert.to(torch.int32), bm=block)


def row_maps(src: torch.Tensor, dest: torch.Tensor, t_pad: int):
    """Per destination row: its source row and whether it has one
    (``row_src``, ``row_valid``, both (t_pad,) int32), from
    ``out[dest[i]] = x[src[i]]``."""
    dest = dest.long()
    row_src = torch.zeros((t_pad,), dtype=torch.int32, device=dest.device)
    row_src[dest] = src.to(torch.int32)
    row_valid = torch.zeros((t_pad,), dtype=torch.int32, device=dest.device)
    row_valid[dest] = 1
    return row_src, row_valid


def coalesced_gather(x: torch.Tensor, src: torch.Tensor, dest: torch.Tensor,
                     t_pad: int, block: int = 128) -> torch.Tensor:
    """out[dest[i]] = x[src[i]]; rows of `out` not hit by `dest` are zero.

    `block` is the reference's row-block size; the Hopper kernel works row
    by row and does not need it.
    """
    del block
    row_src, row_valid = row_maps(src, dest, t_pad)
    return _gather_k.gather_rows(x, row_src, row_valid, t_pad)

